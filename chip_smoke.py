#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

What it runs, at the defaults of ``puppax_torch/configs/experiment.py``
(the flat Pupper v3, 4096 training envs with domain randomization, 5
physics substeps per env step, episode length 1000, unroll length 20,
batch 256 x 32 minibatches, 4 updates per batch, policy MLP 4 x 128 and
value MLP 5 x 256 elu, 128 eval envs; random weights made from ``--seed``):

1. the card's ``nvidia-smi`` name and power limit, torch and CUDA versions;
   then jax's threefry, which every draw of the port launches on the card
   (``puppax_torch/random.py``: the resets, DR, the networks' init, the
   unrolls, SGD and the evaluations draw from jax keys): its kernel
   (``csrc/threefry.cuh``) built first, since the set-up's DR draws
   through it, and held bit for bit against its plain version (run on the
   card) on 2^22 random (key, counter) pairs in the pair, bits and uniform
   modes, the normal within 4 ulp, against jax's values for known keys
   and pairs, and through ``split``, ``uniform``, ``bernoulli``,
   ``choice_p`` and ``permutation`` against the same calls on CPU tensors;
   the emitter's ``powf`` (a solimp power other than 2) against torch's
   CUDA ``pow``; one 4096 x 12 uniform draw timed from a CUDA graph;
2. the builds of the thirty kernels from the checkout's sources, in
   parallel nvcc processes, their bodies rendered in a pool of processes,
   each nvcc started as its body lands (``build.build_batch``): first the
   wrapped env step (K3), the unwrapped env step (K2), the physics-only
   step (K1) and the fused unroll (K4) as team kernels (32 envs per
   block, each env's program split across the block's warps,
   ``kernels/team.py``; team K4 also splits its MLP) and as one-thread
   kernels (one env per thread, the A/B baseline); then, in the
   background (``build.start_batch``, compilers and render processes at
   niceness 19) while the phases use the card, one batch after another,
   each awaited before the first phase that needs it: the bodies of
   run12's env (``dev/run_configs/run12_2b_cse.json``: history 4, the
   privileged rows, the gait clock): team K3, K3, team K2 (history 4
   only), team K4 and K4 (phase 13); the eight bodies of run9's heightfield
   terrain (``dev/run_configs/run9_500m_hfield.json``: the hfield-sphere
   pairs, the grid a table the bodies read): team K1, K2, K3, K4 and their
   one-thread kernels (``[hfield]``), and the five bodies of run8's
   obstacle terrain (``dev/run_configs/run8_500m_obstacles.json``: 20
   boxes, the sphere-box pairs as loops over a table of the boxes): team
   K3, K3, team K2, team K1 and team K4 (``[boxes]``; the one-thread
   K1[boxes] and K4[boxes] are built with g++ by the CPU tests only)
   (phase 14); the capsule model's team K3, K2, K1 and K4 (``[capsule]``;
   its one-thread bodies are built with g++ by the CPU tests only) (phase
   16); the probes' 30 libraries (phase 17). Each build prints its
   generated lines, nvcc seconds and ptxas summary (the team kernels with
   their warps, barriers, shared memory, global scratch and heaviest
   stream). The host-bound numbers of phases 3-13 (the plain versions'
   times, the training runs' phases and ``training/sps``) are taken
   beside those builds; the card's kernel times are not host-bound;
3. K3 against its plain version at 4096 envs: after a few kernel steps
   from a DR reset, one wrapped step through ``wrapped_step`` (team K3),
   ``wrapped_step_one_thread`` (the one-thread K3) and
   ``wrapped_step_rows`` (its plain PyTorch version) on the same inputs,
   held at the parity tolerances env by env, the two kernels bit for bit
   with each other; the same on the first 128 and the first 130 envs (a
   ragged 32-env group), held against the 4096-env plain run's first
   envs (each env's rows are its own: the plain version on those blocks;
   so below wherever a narrower check follows a wider one on the same
   states); both kernels timed at 4096 envs in turns
   (one-thread, team, team, one-thread), the A/B printed, the plain
   version timed on its check's run at 4096 envs (each plain version below
   is timed once, on the run its check compares with);
4. K4 against its plain version: from the K3 check's 4096 DR'd states,
   T=2 steps (``T_PLAIN``) through ``fused_unroll.unroll`` (team K4),
   ``fused_unroll.unroll_one_thread`` (the one-thread K4) and
   ``fused_unroll.unroll_rows``, every step's outputs and the final carry
   held env by env (and counted bit for bit), the two kernels bit for bit
   with each other; the same with the gait clock on at 128 envs; both
   timed per T=4 unroll (the kernels line's unit) and per T=20 unroll at
   4096 envs from the check's states, in turns
   (one-thread, team, team, one-thread), the A/B printed;
5. K1 against its plain version on the same 4096 DR'd states (feet on the
   floor) under the policy's motor targets: ``soa.step_batched`` (team K1)
   and ``soa.step_batched_one_thread`` (one-thread K1) against
   ``soa.physics_step_rows``, env by env, at 4096 envs and at the first
   128, the two kernels bit for bit with each other; both timed at 4096
   and 128 envs in turns (one-thread, team, team, one-thread), the A/B
   printed, the plain version's time at 4096;
6. K1 against the torch ``pipeline.pipeline_step`` (float32, TF32 off) on
   the same inputs, env by env at qpos 5e-5 / scaled qvel 5e-4: the envs
   outside tolerance are counted and split into those outside the MJX caps
   (more than ``max_geom_pairs`` penetrating pairs of one kind, or
   ``max_contact_points`` in all, where the capped pipeline and the
   uncapped kernel part by design), those the emission's line search
   explains (they agree once its trips are raised), and the rest; it fails
   if the rest outnumber the envs outside the caps. The envs whose caches
   part at K1-vs-plain tolerances are counted and printed beside;
7. K2 against its plain version at the evaluator's shape: 128 envs of the
   nominal model reset with their physics caches, a few K2 steps under a
   random policy, then one ``env_step`` and one ``env_step_rows`` on the
   same blocks, all four output blocks held env by env, through team K2
   (``env_step``) and the one-thread K2 (``env_step_one_thread``), and the
   same at 4096 envs (the K3 check's blocks), the two kernels bit for bit
   with each other; both timed at 128 and 4096 envs in turns, the A/B
   printed, the plain version once; then the physics-only env step
   (``PUPPAX_SOA_ENV=off``: the env layer in torch around K1) against the
   K2 step on the same inputs and draws: obs and reward within 2e-4, done
   exact;
8. the rollout lane: ``FastLane.unroll`` with T=20, three times after one
   warm-up, timed with CUDA events, with team K3's launches over those
   unrolls (no one-thread K3), and the unroll's draws alone
   (``draw_noise_block`` + ``draw_eps``) and their share of it; then the
   same with ``PUPPAX_FUSED_UNROLL=on`` (one team K4 launch per unroll, no
   K3 and no one-thread K4), and the A/B of the two;
9. the main path: ``ppo.train`` at the default configuration but for
   491,520 env steps (3 training steps) and 2 evaluations, with its
   checkpoint in a temporary directory; the launches of the kernels are
   counted over exactly this call (120 K3, 2000 K2, 0 K1, 0 K4, all the
   team kernels; the one-thread kernels launch 0 times; threefry at least
   once: every draw of the run), and the
   run is checked (env steps, the normalizer's count, finite losses,
   changed parameters, plausible eval metrics, the checkpoint against the
   final state); then ``tools/eval.py::visualize_policy`` on the trained
   policy (one env of the default env on the card, 560 steps of the
   7-command script, render_every 2): team K2 and the one-thread K2 first
   held bit for bit against ``env_step_rows`` at B = 1 (a ragged block of
   one env), then the rollout's launches (exactly 560 team K2, none of
   the one-thread K2, K1, K3 or K4, threefry at least once), its env
   steps/s (``profiling.Timer`` fenced on the last qpos) and its trajectory
   file (561 finite qpos rows, the last the last step's, the commands 80
   steps each, fps 25, the MJCF ``config_xml`` of the config; without
   mujoco, as on the card's host, no video and None returned);
10. the export of that run's policy: its parameters saved as the training
   CLI saves them, exported through ``python -m
   puppax_torch.scripts.export_policy`` (the file equal, as a string, to
   ``export.convert_params`` called directly), the native runtime
   (``native/policy_runtime.cc``) built with g++ into ``build/`` and
   loaded with ``export.native.NativePolicy``, and replayed on 256 raw
   observations of the K3 check's states: against the runtime's own
   float32 arithmetic (``export.native.runtime_forward``; rtol 1e-5 / atol
   1e-6, every element), ``apply_exported_policy`` (float64; 1e-5 / 1e-6)
   and the card's deterministic policy (TF32 off; 1e-4 / 1e-5), and the
   same fold done in float64 against the card's policy (1e-4 / 1e-5, every
   element); then the same for the K4 check's gait-clock policy (the
   trained normalizer and the clock's statistics), 8 ticks of the
   runtime's own clock after ``reset_clock``; the JSON's size, the layer
   widths, the export's wall time, the observation dims at the
   normalizer's std floor and each largest deviation printed (see
   ``export_and_replay`` for what fails the run);
11. the physics-only lane: the same ``ppo.train`` with
   ``PUPPAX_SOA_ENV=off`` (the fast lane off, training and evaluation
   through the standard lane's env layer around K1) and 1 evaluation
   (after the training): 1120 K1 launches, 0 K2, K3 and K4, the same
   checks;
12. the fused-unroll lane: the same ``ppo.train`` with
   ``PUPPAX_FUSED_UNROLL=on`` and 1 evaluation: the lane line reads
   ``fused-unroll=ON``, 6 team K4 launches (3 training steps x 2
   unrolls), 0 K3, 1000 K2, 0 K1, 0 one-thread K4, the same checks;
13. run12: its team K3 and one-thread K3 against the plain version at
   4096 and 128 DR'd envs after a few steps (every third env at the
   episode limit, so the privileged rows restore from the ``first``
   block), its team K4 and one-thread K4 over T=2 steps at 4096 envs, each
   team kernel bit for bit with its one-thread kernel, its team K2 at
   history 4 against the plain version at 128 envs, and their times in
   turns (K4 per T=4 and per T=20 unroll);
   then ``python -m puppax_torch.scripts.train --config
   dev/run_configs/run12_2b_cse.json`` (4096 envs, the privileged critic,
   ``value_precision`` "high", the cosine lr, the linear entropy schedule)
   for 3 training steps and 1 evaluation (after the training) on each
   lane, the curriculum over those steps: each run's lane line, its
   launches, the difficulty before each training step (at least three
   values), the critic normalizer's count, finite losses and evaluations,
   its ``training/sps``, phase times and evaluation seconds; the K3-lane
   run again as one rank on this card under ``python -m
   torch.distributed.run --standalone --nproc_per_node 1`` (this
   script's ``--launched-cli`` child around the CLI's ``main``, which
   loads the libraries this process built for run12 under their keys;
   the process group NCCL's), with every check of the in-process run, its
   launches by body and curriculum, and these besides: its
   lane line names rank 0 of 1 and the NCCL backend, the JSONL's records
   and the train states are the in-process run's kind for kind (one
   writer), and the learner's collectives are the run's (384 gradient
   all-reduces, one batch all-gather per training step, the two
   normalizers' moments, the advantages', the metrics', the
   evaluation's); its ``training/sps`` beside the in-process run's, the
   launcher's wall split into its parts, and the final weights of the two
   runs compared;
14. run9, the heightfield terrain: 4096 DR'd envs from run9's committed
   tables after ``RUN9_WARM_STEPS`` kernel steps, every eighth moved past
   the grid's edge; the envs with an active hfield-sphere contact on a
   nonzero, sloped cell counted (at least ``MIN_HFIELD_ENVS``); team K1,
   team K3 and team K4 (T=2) at 4096 envs and team K2 at 128 against their
   one-thread kernels and their plain versions, bit for bit (0 envs
   outside, max abs err 0.0), and timed in turns; then ``python -m
   puppax_torch.scripts.train --config dev/run_configs/run9_500m_hfield.json``
   on the K3 lane for 3 training steps and 1 evaluation, its launches
   counted by body (team K3[hfield] and team K2[hfield]), its
   ``training/sps``, phase times and evaluation seconds;
15. run8, the obstacle terrain: 4096 DR'd envs from run8's committed
   tables after ``RUN8_WARM_STEPS`` kernel steps, every second env's base
   moved onto a box where that puts a sphere into it; the envs with an
   active sphere-box row in team K2's last forward pass counted (at least
   ``MIN_BOX_ENVS``); team K3 and the one-thread K3 at 4096 and 128 envs
   and team K2 at 128 against their plain versions (at most
   ``MAX_DIFFERING_ENVS`` envs outside tolerance), team K3 against the
   one-thread K3 bit for bit, timed in turns; team K1[boxes] under the
   policy's motor targets at 4096 envs against ``physics_step_rows`` and at
   128 against that run's first 128 envs (each env's rows are its own),
   the envs with an active sphere-box row in its caches counted; team
   K4[boxes] over ``RUN8_K4_PLAIN_T`` = 1 step at 4096 envs against
   ``unroll_rows`` (the box scratch's reuse across steps is held by the
   CPU tests' g++ builds), at most
   ``MAX_DIFFERING_ENVS`` envs outside tolerance each; team K1[boxes]
   timed at 4096 and 128 envs and team K4[boxes] per T=4 unroll; then
   ``python -m puppax_torch.scripts.train --config
   dev/run_configs/run8_500m_obstacles.json`` for 3 training steps on each
   lane with 1 evaluation: the default (K3) lane, the physics-only lane
   (``PUPPAX_SOA_ENV=off``: 1120 team K1[boxes] launches) and the
   fused-unroll lane (``PUPPAX_FUSED_UNROLL=on``: 6 team K4[boxes] and 1000
   team K2[boxes]), each run's launches counted by body (a launch through
   another body fails the run), its ``training/sps``, phase times and
   evaluation seconds;
16. the capsule-legged Pupper (the bundled model's foot spheres as
   capsules, ``bench.py``'s ``capsule`` variant, written to a temporary
   file from ``model/assets.py``'s tree and read through ``env.path`` and
   its committed tables): 4096 DR'd envs after ``CAPSULE_WARM_STEPS``
   kernel steps; team K3[capsule] at 4096 envs, team K2[capsule] at 128,
   team K1[capsule] at 4096 and 128 and team K4[capsule] over T=4 steps at
   4096 against their plain versions (at most ``MAX_DIFFERING_ENVS`` envs
   outside tolerance; K2 none); the envs with an active plane-capsule,
   sphere-capsule and capsule-capsule row in team K1's caches counted (the
   run fails on no active plane-capsule row); team K1[capsule] against the
   torch ``pipeline_step`` under phase 6's rule (the envs outside the MJX
   caps counted at every substep: the pipeline runs one substep at a
   time); each body timed; then ``python -m
   puppax_torch.scripts.train --set env.path=<file>`` (the default
   TrainConfig) for 3 training steps and 1 evaluation on each lane, its
   launches counted by body (team K3[capsule] + K2[capsule]; 1120 team
   K1[capsule]; 6 team K4[capsule] + 1000 K2[capsule]);
17. the kernel-time probes (``puppax_torch/probes``) on the K1 check's
   4096 DR'd states: their 30 libraries, built in the last background
   batch (K1's
   program cut after each phase, with the sink row that keeps the cut pass
   live, and whole, in two designs: team K1's, split across 4 warps in
   ``csrc/probe_physics_team.cuh``, and one thread per env in
   ``csrc/probe_physics.cuh``; the whole body under ``--fmad=true`` in both
   designs, the multiply-add chain's two designs (8 interleaved elements
   per thread on the resident blocks, and one element per thread) under
   both flags, ``x + 1`` in two designs (float4 on a grid sized to the
   card, launched with programmatic dependent launch, and one element per
   thread), the copy kernel, the synthetic SoA substep at 60
   rounds one thread per env and as a team kernel, the 18 x 18 SPD solve
   one warp per env and one thread per env, and P7's team fk cut with its
   substep loop partitioned),
   then each probe's ``run``: K1's time per phase in both designs in turns
   (each cut held bit for bit against its plain version, the team full cut
   against the production team K1), K1 by layout and threads per block,
   the team fk and full cuts by layout, the chain's two designs in turns
   (the ``--fmad=false`` launches bit for bit with the plain loop and with
   each other, the ``--fmad=true`` redesign bit for bit with the
   ``--fmad=true`` one-element kernel, which needs both builds' SASS to
   show every pair as one FFMA; the issue floors at ``clocks.max.sm`` and
   at the ``clocks.sm`` read under load, each loop's SASS mix) and K1
   under ``--fmad=true`` in both designs against ``--fmad=false`` (at most
   ``MAX_DIFFERING_ENVS`` envs outside qpos 5e-5 / scaled qvel 5e-4), and
   launch overhead eager and from a CUDA graph: ``x + 1``'s two designs
   bit for bit at nb = 4 and 32 and at a ragged and a misaligned count,
   the redesign with and without PDL, the one-element kernel and
   ``torch.add`` in turns, the programmatic edges of a captured PDL chain
   counted (the run fails without them) and the graphed chain at 1, 2, 10
   and 50 launches, with the host's time per launch layer by layer and
   through team K3's and team K1's production wrappers;
   then the copy (element-parallel, and the same file's one-thread copy)
   in its three operand sets at 4096 and at 128 envs, each bit for bit,
   and the launch and host-overhead probes: the copies beside the one-thread
   copy, and the fk cut (P7) as the one-thread cut and as the team build
   whose substep loop is partitioned, each bit for bit with the plain fk
   cut at 4096 and 128 envs, timed in turns;
   the loop around a launch, with the K3 lane's T=20 unroll (team K3)
   eager against one captured CUDA graph (its outputs bit for bit); K1's boundary on the
   physics-only lane (rows-resident, transposed, the transposes alone, the
   splice); the launch cost after each setup stage, one subprocess per
   stage (their setups at once, their windows in turn), and around a host
   sync; then probe group C on the TPU probes'
   own input recipes: the SoA substep (one thread per env, P12's kernel,
   and the team kernel, tried and not adopted but kept as the A/B that
   answers whether the team design pays on a straight-line body: the team
   bit for bit with both the plain version and the one-thread kernel, timed
   in turns; its heaviest stream, barriers and ns per heaviest-stream
   operation printed beside team K1's) and the SPD
   solve (one warp per env, and the one-thread kernel as its A/B, both bit
   for bit at 4096, 128 and a ragged 130 envs, timed in turns at 4096 and
   128), each at 4096 and 128 envs, the solve beside ``cholesky_ex`` +
   ``cholesky_solve`` (within 1e-4 of max|x|) and ``solve_ex``, timed
   eagerly and from a CUDA graph, with their registers and spills. Each
   probe kernel is
   held against its
   plain version (bit for bit; the ``--fmad=true`` builds as above), and
   every probe kernel must have launched in
   this phase;
18. the traces, last, since a ``torch.profiler`` session leaves the host
   slower at every later launch (CUPTI stays subscribed) and would
   stretch each host-bound phase after it: one T=20 K3-lane unroll under
   ``tools/profiling.trace`` (the trace written to
   ``build/traces/``): exactly 20 team K3 launches in the trace, its
   threefry launches, device activities, the 10 kernels of the most
   device time, busy and window ms and idle share (``tools/
   profile_unroll.py``'s definition: the union of the device intervals
   over the CUDA-event window); then the learner's rank path in this
   process: under a one-rank NCCL process group
   (``parallel.maybe_initialize_distributed`` on a free localhost port),
   one minibatch update of a T=20 K3-lane unroll's first 256 envs (the
   normalizer's reduced update, the batch's all-gather, the advantages'
   and the gradients' all-reduces, ``ppo.sgd_pass``) held bit for bit
   against the single-process update on the same data and keys, its
   collectives counted and the group's set-up timed, the single-process
   update traced the same way (no device event fails the run)
   (``one_rank_update_check``);
19. a JSON line of the kernels (launches in their training run or probe
   phase, error against the plain version, times, the bound of the card;
   team K3, team K2, team K1 and team K4 beside the one-thread K3, K2, K1
   and K4, whose launches on the main path are 0; team K2's entry also
   holds ``visualize_launches``, its launches in ``visualize_policy``'s
   rollout; run12's bodies as
   ``wrapped_step_team[run12]``, ``env_step_team[hist4]``,
   ``fused_unroll_team[run12]`` and their one-thread kernels, each with
   the run12 CLI run its launches come from as ``launches_in``; run9's
   eight ``[hfield]`` bodies, launched in run9's CLI run; run8's five
   bodies as ``wrapped_step_team[run8]``, ``wrapped_step[run8]`` and
   ``env_step_team[run8]``, launched in run8's K3-lane CLI run,
   ``physics_step_team[run8]``, launched in its physics-only run, and
   ``fused_unroll_team[run8]``, launched in its fused-unroll run (these
   two with ptxas's registers and spills, the shared and scratch bytes,
   the barriers and the nvcc seconds); the capsule model's four team bodies
   as ``wrapped_step_team[capsule]``, ``env_step_team[capsule]``,
   ``physics_step_team[capsule]`` and ``fused_unroll_team[capsule]``, each
   launched in its lane's CLI run, with the same build numbers; each K4
   entry's ``unroll_T`` the steps of the unroll its times and bound are
   per, ``plain_unroll_T`` those of its plain version's time), the first
   batch's seconds beside the total and, last, the device JSON line.

Each phase prints its wall seconds. Any failed check raises, so the script
exits non-zero; it also exits non-zero, printing no result, when no CUDA
device is visible or when it is run outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

HERE = os.path.dirname(os.path.abspath(__file__))
T_UNROLL = 20
N_UNROLLS = 3
WARM_STEPS = 5  # kernel steps from reset before each kernel/plain check
T_CHECK = 4  # steps of the unroll every K4 entry's time and bound are per
T_PLAIN = 2  # steps of the K4-vs-plain checks (the plain version's cost is per step)
MAX_DIFFERING_ENVS = 4  # of 4096 (K3, K1, K4)
# the line-search trips of the converged emission that explains K1 vs the
# torch pipeline (the kernel's own are soa.LS_EXPAND_ITERS / LS_ILLINOIS_ITERS)
CONVERGED_LS_TRIPS = (40, 200)
EVAL_ENVS = 128
EXPORT_OBS = 256  # raw observations the exported policy is replayed on
VIS_STEPS = 560  # visualize_policy's rollout: 7 commands x 80 steps, one env
# the traces of profiling.trace (the T=20 unroll, the minibatch update)
TRACE_DIR = os.path.join(HERE, "build", "traces")
GAIT_TICKS = 8  # ticks of the native runtime's gait clock
TRAIN_TIMESTEPS = 491_520  # 3 training steps of 256 x 20 x 32 env steps
# the JAX package's best run, driven at full width through the training CLI
RUN12_CONFIG = os.path.join("dev", "run_configs", "run12_2b_cse.json")
# the heightfield terrain's run (a 32 x 32 grid), from its committed tables
RUN9_CONFIG = os.path.join("dev", "run_configs", "run9_500m_hfield.json")
RUN9_WARM_STEPS = 25  # kernel steps from reset: the robots land on the bumps
MIN_HFIELD_ENVS = 1000  # of 4096 with an active contact on a nonzero, sloped cell
# the obstacle terrain's run (20 boxes), from its committed tables
RUN8_CONFIG = os.path.join("dev", "run_configs", "run8_500m_obstacles.json")
RUN8_WARM_STEPS = 5  # kernel steps from reset before its checks
MIN_BOX_ENVS = 64  # of 4096 with an active sphere-box row
CAPSULE_WARM_STEPS = 5  # kernel steps from reset before the capsule model's checks
RUN8_K4_PLAIN_T = 1  # steps of team K4[boxes]'s check (its plain version: ~20 s a step)
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


# jax.random's values (jax 0.9.0, threefry2x32, partitionable) for a few
# seeds: split(key, 3), fold_in(key, 17), bits(key, (4,)) and the bits of
# uniform(key, (3,), minval=0.6, maxval=1.4), as uint32
THREEFRY_KNOWN = {
    0: ([[1797259609, 2579123966], [928981903, 3453687069], [4146024105, 2718843009]],
        [2763999920, 494843597], [4070199207, 4202968722, 1427181096, 2012915765],
        [1068357458, 1068564911, 1063102271]),
    42: ([[1832780943, 270669613], [64467757, 2916123636], [2465931498, 255383827]],
         [2702347784, 925058353], [2098992034, 2919706841, 2646866425, 2409546199],
         [1065201678, 1066559814, 1066133501]),
    2**31 - 1: ([[3894554595, 3657610310], [2391852627, 3342111533], [1746298583, 1015193934]],
                [2145647974, 720118821], [840997797, 1235506558, 1419036569, 1650994062],
                [1061270447, 1062503287, 1063076818]),
}
# threefry_2x32's known answers (key, counter) -> (y0, y1), from jax 0.9.0
THREEFRY_PAIRS = (((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
                  ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
                  ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)))
THREEFRY_ROWS, THREEFRY_COUNTERS = 4096, 1024  # 2^22 pairs held against the plain hash
THREEFRY_TIMED = (4096, 12)  # the timed draw: 12 uniforms for each of 4096 envs


def fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def threefry_checks(device, g) -> dict:
    """The threefry kernel (``csrc/threefry.cuh``) on the card: every mode
    bit for bit with the plain ``threefry_rows`` (run on the card) on 2^22
    random (key, counter) pairs, the normal within 4 ulp; jax's own values
    for known keys and pairs; ``split``, ``uniform``, ``bernoulli``,
    ``choice_p`` and ``permutation`` through the kernel bit for bit with
    their plain versions (the same calls on CPU tensors); the emitter's
    ``powf`` against torch's CUDA ``pow``. Times one 4096 x 12 uniform draw
    from a CUDA graph, its plain version eagerly. Raises on any
    difference; returns the numbers of the ``kernels`` line."""
    import numpy as np
    import torch

    from puppax_torch import random as prandom
    from puppax_torch.kernels import build
    from puppax_torch.probes import common as probes

    R, n = THREEFRY_ROWS, THREEFRY_COUNTERS
    keys = torch.randint(-2**31, 2**31, (R, 2), generator=g, device=device, dtype=torch.int64)
    keys = keys.to(torch.int32)
    offset = int(torch.randint(0, 2**31, (1,), generator=g, device=device))
    lo = torch.rand(n, generator=g, device=device) * -3
    hi = torch.rand(n, generator=g, device=device) * 3
    worst_ulp, max_err = 0, 0.0
    for mode, name in ((prandom.PAIRS, "pairs"), (prandom.BITS, "bits"),
                       (prandom.UNIFORM, "uniform"), (prandom.NORMAL, "normal")):
        bounds = (lo, hi) if mode == prandom.UNIFORM else (None, None)
        got = prandom.threefry(keys, n, mode, offset, *bounds)
        want = prandom.threefry_rows(keys, n, mode, offset, *bounds)
        gap = (got.view(torch.int32).to(torch.int64) - want.view(torch.int32).to(torch.int64)).abs()
        differ = int((gap > 0).sum())
        if got.dtype.is_floating_point:
            max_err = max(max_err, float((got - want).abs().max()))
        elif differ:
            max_err = math.inf
        print(f"threefry {name} vs plain on {R} x {n} pairs (offset {offset}): {differ} of "
              f"{gap.numel()} words differ, largest gap {int(gap.max())}", flush=True)
        if mode == prandom.NORMAL:
            worst_ulp = int(gap.max())
            if worst_ulp > 4:
                raise AssertionError(f"threefry normal: {worst_ulp} ulp from the plain version")
        elif differ:
            raise AssertionError(f"threefry {name}: the kernel differs from the plain version")
    # jax's values
    for seed, (split3, fold17, bits4, unif) in THREEFRY_KNOWN.items():
        k = prandom.key(seed, device)
        got = [prandom.split(k, 3), prandom.fold_in(k, 17), prandom.random_bits(k, (4,)),
               prandom.uniform(k, (3,), 0.6, 1.4).view(torch.int32)]
        for x, want, what in zip(got, (split3, fold17, bits4, unif),
                                 ("split", "fold_in", "bits", "uniform")):
            if not np.array_equal(x.cpu().numpy().view(np.uint32), np.array(want, np.uint32)):
                raise AssertionError(f"threefry {what} of PRNGKey({seed}) is not jax's")
    for (k0, k1, x0, x1), want in THREEFRY_PAIRS:
        y = prandom.threefry2x32(*(torch.tensor(v, dtype=torch.int64, device=device)
                                   for v in (k0, k1, x0, x1)))
        if (int(y[0]), int(y[1])) != want:
            raise AssertionError(f"threefry2x32 of {(k0, k1, x0, x1)} is not jax's")
    print(f"threefry: jax's values for {len(THREEFRY_KNOWN)} keys (split, fold_in, bits, "
          f"uniform) and {len(THREEFRY_PAIRS)} known pairs: equal", flush=True)
    # the draws through the kernel against the same calls on the CPU
    draw_keys = prandom.split(prandom.key(7, device), 4096)
    cpu_keys = draw_keys.cpu()
    p = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    draws = (("split", lambda k: prandom.split(k, 6)),
             ("uniform", lambda k: prandom.uniform(k, (12,), -1.0, 1.0)),
             ("uniform, per-element bounds", lambda k: prandom.uniform(
                 k, (3,), (-0.03, -0.01, -0.02), (0.03, 0.01, 0.02))),
             ("bernoulli", lambda k: prandom.bernoulli(k, 0.02, (1,))),
             ("choice", lambda k: prandom.choice_p(k, p)),
             ("permutation", lambda k: prandom.permutation(k[0], 8192)))
    for name, fn in draws:
        got, want = fn(draw_keys).cpu(), fn(cpu_keys)
        if got.dtype.is_floating_point:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            raise AssertionError(f"threefry {name}: the card's draw differs from the plain one")
    print(f"threefry draws through the kernel vs their plain versions (bit for bit): "
          f"{', '.join(name for name, _ in draws)}", flush=True)
    # the emitter's powf (a solimp power other than 2) against torch's CUDA pow
    x = torch.rand(4096, generator=g, device=device)
    y = torch.full_like(x, 2.5)
    y[1::2] = 3.0
    out = torch.empty_like(x)
    lib = build.threefry_library()
    build.launch_into("pow_check", lib.pow_check_launch, [x, y, out], x.numel())
    pow_differ = int((out.view(torch.int32) != torch.pow(x, y).view(torch.int32)).sum())
    print(f"powf (the emitter's text) vs torch.pow on the card at 4096 values, exponents 2.5 "
          f"and 3: {'bit for bit' if pow_differ == 0 else f'{pow_differ} values differ'}",
          flush=True)
    # the timed draw: 12 uniforms per env, from a CUDA graph
    B_, n_ = THREEFRY_TIMED
    tkeys = draw_keys[:B_].contiguous()
    tlo = torch.full((n_,), -1.0, device=device)
    thi = torch.full((n_,), 1.0, device=device)
    prandom.threefry(tkeys, n_, prandom.UNIFORM, 0, tlo, thi)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(probes.ITERS):
            prandom.threefry(tkeys, n_, prandom.UNIFORM, 0, tlo, thi)
    ms = probes.best_ms(graph.replay) / probes.ITERS
    plain_ms = statistics.median(
        cuda_ms(lambda: prandom.threefry_rows(tkeys, n_, prandom.UNIFORM, 0, tlo, thi), 5)
        for _ in range(3))
    in_bytes = tkeys.numel() * 4 + (tlo.numel() + thi.numel()) * 4
    out_bytes = B_ * n_ * 4
    bound = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    pair_bound = 24 * B_ * n_ / PEAK_BYTES_PER_S * 1e3
    print(f"threefry uniform {B_} x {n_}: {ms * 1e3:.3f} us per launch from a CUDA graph "
          f"({probes.ITERS} launches per replay); plain version {plain_ms:.3f} ms eager; bound "
          f"{bound * 1e3:.4f} us ({in_bytes + out_bytes} bytes over 3.35 TB/s); at 24 bytes per "
          f"pair {pair_bound * 1e3:.4f} us", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, worst_normal_ulp=worst_ulp,
                pow_differ=pow_differ, max_abs_err=max_err)


def capsule_xml_file() -> str:
    """The capsule-legged Pupper's MJCF written to a temporary file: the
    bundled model (``puppax_torch/model/assets.py``) with its 4 foot spheres
    as capsules of radius 0.015 and half-length 0.02 (``bench.py``'s
    ``capsule`` variant). The port reads its committed tables through
    ``env.path``, keyed by this content."""
    import xml.etree.ElementTree as ET

    from puppax_torch.model import assets

    tree = assets.pupper_xml_tree()
    feet = [geom for geom in tree.getroot().iter("geom")
            if geom.get("type") == "sphere" and geom.get("size") == "0.01995"]
    if len(feet) != 4:
        raise AssertionError(f"{len(feet)} foot spheres in the bundled model, expected 4")
    for geom in feet:
        geom.set("type", "capsule")
        geom.set("size", "0.015 0.02")
    path = os.path.join(tempfile.mkdtemp(prefix="puppax_torch_capsule_"), "pupper_capsule.xml")
    with open(path, "w") as f:
        f.write(ET.tostring(tree.getroot(), encoding="unicode"))
    return path


def place_over_boxes(s, model_t, q, envs, g, rounds: int = 64):
    """Move the bases (x, y) of the envs of the bool mask ``envs`` of the
    ``(nq, B)`` block ``q`` onto the box model's boxes, each to the first of
    ``rounds`` random poses (along a random box, at most 15 cm across it)
    where a sphere penetrates a box; an env with no such pose keeps its
    own. Returns (the new q, the bool mask of the envs with a penetrating
    sphere-box pair)."""
    import torch

    from puppax_torch.physics import collision, smooth

    bx = s.boxes
    nbs = bx.n * len(bx.spheres)
    table = torch.tensor(bx.table, dtype=torch.float32, device=q.device)  # (n, 15)

    def box_contact(qq):
        dist = collision.collide_pairs(model_t, smooth.kinematics(model_t, qq.t())).dist
        return (dist[:, bx.first:bx.first + nbs] < 0).any(1)

    q = q.clone()
    hit = box_contact(q)
    for _ in range(rounds):
        todo = envs & ~hit
        if not todo.any():
            break
        k = torch.randint(bx.n, (q.shape[1],), generator=g, device=q.device)
        along = (torch.rand(q.shape[1], generator=g, device=q.device) - 0.5) * 2 * table[k, 13]
        across = (torch.rand(q.shape[1], generator=g, device=q.device) - 0.5) * 0.3
        # the box's local y (its length) and x axes in the world: R's columns
        xy = table[k, 9:11] + along[:, None] * table[k][:, [1, 4]] \
            + across[:, None] * table[k][:, [0, 3]]
        cand = q.clone()
        cand[0:2] = torch.where(todo, xy.t(), q[0:2])
        ok = todo & box_contact(cand)
        q[0:2] = torch.where(ok, cand[0:2], q[0:2])
        hit = hit | ok
    return q, hit


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """``fn()``'s result and its milliseconds (CUDA events, one call): a
    plain version is run once, for its check, and that run is its time."""
    out = []
    ms = cuda_ms(lambda: out.append(fn()), 1)
    return out[0], ms


def trace_launches(summary: dict, kernel: str) -> int:
    """Launches of a kernel (its function's name) in a ``profiling.trace``
    summary; the trace names a kernel by its demangled signature."""
    return sum(n for name, n in summary["launches"].items() if kernel in name)


def print_trace(label: str, tr) -> dict:
    """A ``profiling.trace``'s numbers: device activities in all, the 10
    kernels of the most device time, busy and window ms, the idle share and
    the trace file's bytes."""
    s = tr.summary
    top = sorted(s["device_us"].items(), key=lambda kv: -kv[1])[:10]
    clock = "CUDA events" if tr.on_card else "host clock"
    print(f"{label} trace: {sum(s['launches'].values())} device activities (kernels, copies, "
          f"sets), device busy {s['busy_ms']:.3f} ms in a window of {s['window_ms']:.3f} ms "
          f"({clock}), idle share {s['idle']:.4f}; trace file {os.path.getsize(tr.path)} "
          f"bytes ({os.path.relpath(tr.path, HERE)})", flush=True)
    print(f"{label} trace, top 10 by device time: " + json.dumps(
        [{"name": name[:90], "launches": s["launches"][name], "device_ms": us / 1000.0}
         for name, us in top]), flush=True)
    return s


def bound_ms(ops_per_env: int, in_rows: int, out_rows: int, B: int):
    """The least time the card could take for one step of ``B`` envs: the
    larger of the float operations over the fp32 peak and the bytes (each
    input row read once, each output row written once) over the HBM rate."""
    t_ops = ops_per_env * B / PEAK_FP32_FLOPS * 1e3
    t_bytes = (in_rows + out_rows) * 4 * B / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def build_numbers(record: str) -> dict:
    """A team build's numbers from its record (``build.last_build``) and its
    ``build.log``: ptxas's registers and spill bytes (the largest over the
    library's kernels), the shared and global scratch bytes, the barriers
    one stream passes, the nvcc seconds."""
    import re

    from puppax_torch.kernels import build

    info = build.last_build[record]
    log = open(os.path.join(info["dir"], "build.log")).read()

    def most(pattern):
        return max((int(x) for x in re.findall(pattern, log)), default=0)

    return {"registers": most(r"Used (\d+) registers"),
            "spill_store_bytes": most(r"(\d+) bytes spill stores"),
            "spill_load_bytes": most(r"(\d+) bytes spill loads"),
            "shared_bytes": info["shared_bytes"],
            "scratch_bytes_per_env": info.get("scratch_bytes_per_env", 0),
            "barriers": info["barriers"], "nvcc_s": info["compile_seconds"]}


def _differing(names, got, want, tols):
    """The envs whose outputs leave tolerance: [(env, what)], and the max
    error per block. Fails on a NaN in either version."""
    import torch

    for name, g, w in zip(names, got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"kernel output block {name} holds NaN/inf")
        if not torch.isfinite(w).all():
            raise AssertionError(f"plain output block {name} holds NaN/inf")
    err = {n: (g - w).abs() for n, g, w in zip(names, got, want)}
    differing = {}  # env -> the first comparison that failed
    for i, name in enumerate(names):
        bad = err[name] > tols[name]
        for b in torch.nonzero(bad.any(0)).flatten().tolist():
            r = int(torch.argmax(err[name][:, b] - tols[name][:, b]))
            differing.setdefault(b, f"{name} row {r}: kernel {float(got[i][r, b])!r} "
                                    f"plain {float(want[i][r, b])!r}")
    per_block = {n: float(e.max()) for n, e in err.items()}
    return per_block, sorted(differing.items()), max(per_block.values())


def _scaled(want_rows, tol):
    return tol * want_rows.abs().amax(0, keepdim=True).clamp_min(1.0).expand_as(want_rows)


def compare_outputs(s, es, aux_rows, got, want):
    """Hold K3's 5 output blocks against the plain version's at the parity
    tolerances, env by env. Returns (per-block max error, list of (env,
    what) for the envs that differ, overall max error)."""
    return _differing(("q", "v", "env", "wrap", "aux"), got, want,
                      wrapped_tols(es, aux_rows, got, want))


def wrapped_tols(es, aux_rows, got, want):
    """K3's tolerances, block by block (q, v, env, wrap, aux)."""
    import torch

    tols = {
        "q": torch.full_like(got[0], 5e-5),
        "v": _scaled(want[1], 5e-4),
        "env": torch.full_like(got[2], 1e-4),
        "wrap": torch.zeros_like(got[3]),
        "aux": torch.full_like(got[4], 2e-4),
    }
    tol_env = tols["env"]
    for name, tol in (("obs_history", 2e-4), ("action_buffer", 1e-6),
                      ("command", 1e-6), ("desired_z", 1e-6), ("last_act", 1e-6),
                      ("feet_air_time", 1e-5), ("last_contact", 0.0), ("step", 0.0)):
        r0, n = es.env_rows[name]
        tol_env[r0 : r0 + n] = tol
    r0, n = es.env_rows["last_vel"]
    tol_env[r0 : r0 + n] = _scaled(want[1], 5e-4)[:1].expand(n, -1)
    tol_aux = tols["aux"]
    for name in ("done", "truncation"):
        tol_aux[aux_rows[name][0]] = 0.0
    r0, n = aux_rows["rewards"]
    tol_aux[r0 : r0 + n] = 2e-4 * want[4][r0 : r0 + n].abs().clamp_min(1.0)
    if "privileged" in aux_rows:  # the velocities among them as qvel, the rest 2e-4
        r0, _ = aux_rows["privileged"]
        vel = torch.cat([want[4][r0 : r0 + 6], want[4][r0 + 9 : r0 + 21]])
        scale = 5e-4 * vel.abs().amax(0, keepdim=True).clamp_min(1.0)
        tol_aux[r0 : r0 + 6] = scale.expand(6, -1)
        tol_aux[r0 + 9 : r0 + 21] = scale.expand(12, -1)
    return tols


def compare_unroll(s, es, aux_rows, got, want):
    """Hold K4's outputs (``fused_unroll.unroll``'s 10) against the plain
    version's, env by env: the final carry as K3's outputs, every step's aux
    rows as K3's aux, the observations, actions and raw actions at 1e-5,
    the log-prob at 2e-4 and the clock's phase at 1e-6. Returns what
    ``compare_outputs`` returns."""
    import torch

    T, B = got[9].shape[0], got[9].shape[2]
    steps = [wrapped_tols(es, aux_rows, [*got[:4], got[9][t]], [*want[:4], want[9][t]])
             for t in range(T)]
    tols = dict(steps[-1], aux=torch.cat([x["aux"] for x in steps]))
    names = ["q", "v", "env", "wrap", "aux", "obs", "act", "raw", "logp"]
    g = [*got[:4], *(x.reshape(-1, B) for x in (got[9], *got[5:9]))]
    w = [*want[:4], *(x.reshape(-1, B) for x in (want[9], *want[5:9]))]
    for name, x, tol in zip(names[5:], g[5:], (1e-5, 1e-5, 1e-5, 2e-4)):
        tols[name] = torch.full_like(x, tol)
    if got[4] is not None:
        names.append("phase")
        g.append(got[4])
        w.append(want[4])
        tols["phase"] = torch.full_like(got[4], 1e-6)
    return _differing(names, g, w, tols)


def compare_env_outputs(s, es, got, want):
    """Hold K2's 4 output blocks (q, v, caches, env_out) against the plain
    version's, env by env: qpos and positions 5e-5; velocities,
    accelerations and forces 5e-4 times max(1, the env's largest
    magnitude); the env-out rows at ``tests/test_soa_env.py``'s tolerances."""
    import torch

    names = ("q", "v", "caches", "env_out")
    tols = {
        "q": torch.full_like(got[0], 5e-5),
        "v": _scaled(want[1], 5e-4),
        "caches": torch.full_like(got[2], 5e-5),
        "env_out": torch.full_like(got[3], 1e-4),
    }
    for name in ("qacc", "xd_ang", "xd_vel", "qfrc_actuator"):
        r0, n = s.cache_rows[name]
        tols["caches"][r0 : r0 + n] = _scaled(want[2][r0 : r0 + n], 5e-4)
    for name, tol in (("obs_history", 2e-4), ("reward", 2e-4), ("done", 0.0),
                      ("action_buffer", 1e-6), ("imu_buffer", 1e-4), ("command", 1e-6),
                      ("desired_z", 1e-6), ("feet_air_time", 1e-5), ("last_contact", 0.0),
                      ("step", 0.0), ("total_dist", 1e-4)):
        r0, n = es.out_rows[name]
        tols["env_out"][r0 : r0 + n] = tol
    r0, n = es.out_rows["rewards"]
    tols["env_out"][r0 : r0 + n] = 2e-4 * want[3][r0 : r0 + n].abs().clamp_min(1.0)
    return _differing(names, got, want, tols)


def physics_tols(s, want):
    """K1's tolerances, block by block (q, v, caches): qpos and positions
    5e-5; velocities, accelerations and forces 5e-4 times max(1, the env's
    largest magnitude)."""
    import torch

    tols = {
        "q": torch.full_like(want[0], 5e-5),
        "v": _scaled(want[1], 5e-4),
        "caches": torch.full_like(want[2], 5e-5),
    }
    for name in ("qacc", "xd_ang", "xd_vel", "qfrc_actuator"):
        r0, n = s.cache_rows[name]
        tols["caches"][r0 : r0 + n] = _scaled(want[2][r0 : r0 + n], 5e-4)
    return tols


def compare_physics_outputs(s, got, want):
    """Hold K1's 3 output blocks against another version's, env by env."""
    return _differing(("q", "v", "caches"), got, want, physics_tols(s, want))


def n_outside_differing(differing, outside) -> int:
    """How many of the differing envs lie outside the MJX caps."""
    return sum(1 for b, _ in differing if bool(outside[b]))


def state_blocks(s, ps):
    """A PhysicsState as K1's 3 output blocks (q, v, caches)."""
    import torch

    B = ps.qpos.shape[0]
    parts = {"qacc": ps.qacc, "xpos": ps.xpos, "xquat": ps.x_rot, "xd_ang": ps.xd_ang,
             "xd_vel": ps.xd_vel, "site_xpos": ps.site_xpos,
             "qfrc_actuator": ps.qfrc_actuator, "con_dist": ps.contact_dist,
             "con_pos": ps.contact_pos}
    caches = torch.cat([parts[name].reshape(B, n) for name, (_, n) in s.cache_rows.items()],
                       1).t().contiguous()
    return ps.qpos.t().contiguous(), ps.qvel.t().contiguous(), caches


def _outside(got, want, rtol, atol):
    """(largest |got - want|, elements outside ``atol + rtol * |want|``)."""
    import numpy as np

    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(err.max()), int((err > atol + rtol * np.abs(want)).sum())


def export_and_replay(label, norm, nets, raw_obs, env, env_cfg, tc, device, gait):
    """Export ``(norm, nets)`` to the robot's JSON through the export CLI
    (``python -m puppax_torch.scripts.export_policy``) from a checkpoint the
    training CLI's way; hold the file against ``export.convert_params``
    called directly (the same string), then replay it in the native runtime
    (``export.native.NativePolicy``, built with g++) on ``raw_obs``
    (``(n, 72)``, on the card): against ``native.runtime_forward`` (the
    runtime's float32 arithmetic in numpy) and ``apply_exported_policy``
    (float64) at rtol 1e-5 / atol 1e-6, and against the card's deterministic
    policy (TF32 off) at 1e-4 / 1e-5, beside the float64 replay of the same
    fold done in float64. With ``gait`` the policy takes the clock:
    ``GAIT_TICKS`` ticks of ``infer_clocked`` after ``reset_clock``, tick t
    against the card's policy on ``[obs, cos phi_t, sin phi_t]``, phi_t = 2
    pi f dt t mod 2 pi.

    It fails unless the runtime matches its float32 arithmetic and the
    exact fold the card's policy at every element. Elements outside the
    other two tolerances are then the float32 rounding of the JSON's fold
    and evaluation, and are counted, not failed: a normalizer std at its
    1e-6 floor (an observation that never changed, like the desired body z
    without pitch or roll commands) multiplies that column of the folded
    kernel by 1e6, and the reference's fold and runtime, which the export
    reproduces exactly, round it in float32."""
    import numpy as np
    import torch

    from puppax_torch.export import apply_exported_policy, convert_params, fold_in_normalization
    from puppax_torch.export.native import NativePolicy, build_native_runtime, runtime_forward
    from puppax_torch.export.params import normalizer_arrays, policy_layers
    from puppax_torch.scripts import export_policy
    from puppax_torch.train import checkpoint, ppo, running_statistics
    from puppax_torch.train.distribution import NormalTanhDistribution

    tmp = tempfile.mkdtemp(prefix="puppax_torch_export_")
    ckpt, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "policy.json")
    checkpoint.save_checkpoint(TRAIN_TIMESTEPS, ppo.params_state_dict((norm, nets)), ckpt)
    abi = dict(activation=tc.activation, action_scale=env_cfg.action_scale,
               kp=env_cfg.position_control_kp, kd=env_cfg.dof_damping,
               observation_history=env_cfg.observation_history,
               gait_frequency=env_cfg.gait_frequency, control_dt=env_cfg.environment_timestep)
    argv = ["--checkpoint", ckpt, "--out", out, "--device", str(device),
            *[a for k, v in abi.items() for a in (f"--{k.replace('_', '-')}", str(v))]]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as cli_out:
        export_policy.main(argv + (["--gait-phase-observation"] if gait else []))
    export_s = time.perf_counter() - t0
    text = open(out).read()
    exported = json.loads(text)
    direct = convert_params(
        (norm, nets.policy), default_pose=env._default_pose, joint_upper_limits=env.uppers,
        joint_lower_limits=env.lowers, use_imu=True, maximum_pitch_command=0.0,
        maximum_roll_command=0.0, gait_phase_observation=gait, **abi)
    if text != json.dumps(direct):
        raise AssertionError(f"export of {label}: the CLI's JSON differs from convert_params'")
    t0 = time.perf_counter()
    lib = build_native_runtime()
    build_s = time.perf_counter() - t0
    policy = NativePolicy(out, lib)
    widths = [exported["in_shape"][1]] + [lay["shape"][1] for lay in exported["layers"]]
    print(f"export of {label}: {cli_out.getvalue().strip()}; {len(text)} bytes of JSON, layer "
          f"widths {widths}, export CLI {export_s:.3f} s wall, native runtime {build_s:.3f} s "
          f"(g++ or cached: {lib}); CLI JSON == convert_params JSON: True", flush=True)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if gait:
            n = GAIT_TICKS
            phases = (2.0 * np.pi * abi["gait_frequency"] * abi["control_dt"] * np.arange(n)
                      % (2.0 * np.pi))
            clock = torch.tensor(np.stack([np.cos(phases), np.sin(phases)], 1),
                                 dtype=torch.float32, device=device)
            full = torch.cat([raw_obs[:n], clock], 1)
            policy.reset_clock()
            native = np.stack([policy.infer_clocked(o) for o in raw_obs[:n].cpu().numpy()])
        else:
            full = raw_obs
            native = np.stack([policy(o) for o in full.cpu().numpy()])
        with torch.no_grad():
            card = NormalTanhDistribution(policy.out_dim).mode(
                nets.policy(running_statistics.normalize(full, norm))).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    policy.close()
    obs = full.cpu().numpy()
    replay = apply_exported_policy(exported, obs)
    # the same fold in float64 from the same float32 weights, replayed in
    # float64: the policy the JSON would carry without float32 rounding
    mean, std = (a.astype(np.float64) for a in normalizer_arrays(norm))
    exact = [(k.astype(np.float64), b.astype(np.float64)) for k, b in policy_layers(nets.policy)]
    exact[0] = fold_in_normalization(*exact[0], mean, std)
    half = exact[-1][1].shape[0] // 2
    exact[-1] = (exact[-1][0][:, :half], exact[-1][1][:half])
    ideal = apply_exported_policy({"layers": [
        {"weights": w, "activation": lay["activation"]}
        for w, lay in zip(exact, exported["layers"])]}, obs)
    checks = {  # name: (deviation, elements outside, tolerance)
        "vs the runtime's float32 arithmetic (runtime_forward)":
            (*_outside(native, runtime_forward(exported, obs), 1e-5, 1e-6), "1e-5 / 1e-6"),
        "vs apply_exported_policy (float64)":
            (*_outside(native, replay, 1e-5, 1e-6), "1e-5 / 1e-6"),
        "vs the card's policy (TF32 off)": (*_outside(native, card, 1e-4, 1e-5), "1e-4 / 1e-5"),
        "the exact float64 fold's replay vs the card's policy":
            (*_outside(ideal, card, 1e-4, 1e-5), "1e-4 / 1e-5"),
        "apply_exported_policy vs the card's policy":
            (*_outside(replay, card, 1e-4, 1e-5), "1e-4 / 1e-5"),
    }
    clamped = int((std <= 1e-6 * (1 + 1e-6)).sum())
    what = f"{len(native)} ticks of the gait clock" if gait else f"{len(native)} raw observations"
    print(f"export of {label}, native runtime on {what} ({clamped} of {len(std)} observation "
          f"dims at the normalizer's std floor 1e-6; largest |folded weight| "
          f"{max(abs(v) for row in exported['layers'][0]['weights'][0] for v in row):.6g}):",
          flush=True)
    for name, (err, outside, tol) in checks.items():
        print(f"  {name}: max abs err {err!r}, {outside} of {native.size} outside rtol / atol "
              f"{tol}", flush=True)
    names = list(checks)
    # the runtime must compute the JSON's float32 forward pass, and the
    # exact fold must give the card's policy, at every element; where those
    # hold, what parts the runtime from the float64 replay and from the card
    # is the float32 rounding of the JSON's fold and of its evaluation
    # (large where a std sits at its floor: the fold multiplies by 1e6)
    for name in (names[0], names[3]):
        if checks[name][1]:
            raise AssertionError(f"export of {label}: {name}: {checks[name][1]} elements outside "
                                 f"rtol / atol {checks[name][2]}")
    inside = int((np.abs(native) < 0.99).sum())
    print(f"  {inside} of {native.size} actions inside (-0.99, 0.99)", flush=True)
    if inside == 0:
        raise AssertionError(f"export of {label}: every action saturates, so the comparisons "
                             f"above hold nothing")
    for name in (names[1], names[2]):
        if checks[name][1]:
            print(f"  {name}: the {checks[name][1]} elements outside tolerance are the float32 "
                  f"rounding of the JSON's fold and evaluation (the two checks above hold at "
                  f"every element)", flush=True)
    if not (np.isfinite(native).all() and (np.abs(native) <= 1.0).all()):
        raise AssertionError(f"export of {label}: the native actions leave [-1, 1]")


def one_rank_update_check(lane, wrapped, policy_params, reset_keys, key_net, key_sgd, tc,
                          device, trace_dir=None) -> dict:
    """One minibatch update through the learner's rank path under a
    one-rank NCCL process group against the single-process update, on the
    same data and keys: a T=20 unroll of the K3 lane from ``reset_keys``
    (its key split off ``key_net``), its first ``tc.batch_size`` envs the
    minibatch; the normalizer's update
    (``running_statistics.update(mesh=)``), the batch's gather
    (``ppo.gather_batch``) and one SGD pass of one minibatch
    (``ppo.sgd_pass``: the advantages' reductions, the gradients'
    all-reduce, ``Adam.step``), from networks made from ``key_net`` and the
    SGD's key ``key_sgd``. A world of one sums one term, so the normalizer,
    the weights and Adam's state must agree bit for bit; the group's
    collectives are counted. The group is NCCL's on the card (gloo where
    ``device`` is the CPU: the CPU tests run this check). The
    single-process update runs under ``profiling.trace`` (into
    ``trace_dir``, default a temporary directory), which fails on the card
    if the trace holds no device event: its launches, device busy time and
    idle share are printed. Returns the group's set-up seconds, the counts
    and the trace's summary."""
    import socket

    import torch
    import torch.distributed as dist

    from puppax_torch import random as prandom
    from puppax_torch.parallel import mesh as mesh_lib
    from puppax_torch.tools import profiling
    from puppax_torch.train import networks, ppo, running_statistics

    state = wrapped.reset(reset_keys)
    key_unroll, key_net = prandom.split(key_net).unbind(0)
    _, data = lane.unroll(state, policy_params, key_unroll, T_UNROLL)
    cols = tc.batch_size
    data = ppo._map_data(lambda x: x[:, :cols].contiguous(), data)
    obs_size, act = data.observation.shape[-1], data.action.shape[-1]

    def update(mesh):
        nets = networks.make_ppo_networks(
            obs_size, act, tc.policy_hidden_layer_sizes, tc.value_hidden_layer_sizes,
            tc.activation, device=device, key=key_net, value_precision=tc.value_precision)
        opt = ppo.Adam(list(nets.policy_network.parameters())
                       + list(nets.value_network.parameters()),
                       ppo.lr_schedule_fn(tc.learning_rate, "constant", 0.0, 1))
        norm = running_statistics.update(running_statistics.init_state(obs_size, device),
                                         data.observation, mesh=mesh)
        sums = {}
        ppo.sgd_pass(nets, opt, (norm, None), ppo.gather_batch(data, mesh, 1), key_sgd,
                     tc.entropy_cost, mesh=mesh, batch_size=cols, num_minibatches=1, sums=sums,
                     discounting=tc.discounting, gae_lambda=tc.gae_lambda,
                     clipping_epsilon=tc.clipping_epsilon, reward_scaling=tc.reward_scaling)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return ([getattr(norm, f) for f in ("count", "mean", "summed_variance", "std")]
                + [p.detach().clone() for p in opt.params] + opt.mu + opt.nu
                + list(sums.values()), opt.count)

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="puppax_torch_trace_")
    with profiling.trace(trace_dir, "minibatch_update", device=device) as tr:
        alone = update(mesh_lib.make_env_mesh([device]))
    update_trace = print_trace(f"one minibatch update ({T_UNROLL} x {cols} transitions, "
                               f"single process)", tr)
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    t0 = time.perf_counter()
    mesh_lib.maybe_initialize_distributed(device=device, coordinator_address=f"localhost:{port}",
                                          num_processes=1, process_id=0)
    init_s = time.perf_counter() - t0
    try:
        mesh = mesh_lib.make_env_mesh([device])
        before = dict(mesh_lib.calls)
        ranked = update(mesh)
        calls = {k: v - before.get(k, 0) for k, v in mesh_lib.calls.items()
                 if v != before.get(k, 0)}
    finally:
        dist.destroy_process_group()
    differ = sum(int(not torch.equal(a, b)) for a, b in zip(alone[0], ranked[0]))
    worst = max(float((a.double() - b.double()).abs().max()) for a, b in zip(alone[0], ranked[0]))
    want_calls = {"normalizer": 2, "batch": 1, "advantages": 2, "grads": 1}
    backend = "nccl" if device.type == "cuda" else "gloo"
    print(f"one-rank {backend} group (world {mesh.world}, backend {mesh.backend}) joined in "
          f"{init_s:.3f} s; one minibatch update ({T_UNROLL} x {cols} transitions) through the "
          f"rank path against the single process: {differ} of {len(alone[0])} tensors differ "
          f"(normalizer, weights, Adam's moments, loss parts), max abs err {worst}, Adam count "
          f"{ranked[1]} / {alone[1]}; collectives {json.dumps(calls)} (expected "
          f"{json.dumps(want_calls)})", flush=True)
    if differ or (ranked[1], alone[1]) != (1, 1) or calls != want_calls or mesh.backend != backend:
        raise AssertionError(f"the one-rank {backend} update is not the single-process update "
                             f"bit for bit")
    return {"init_seconds": init_s, "calls": calls, "trace": update_trace}


TEAM_LIBS = ("wrapped_step_team_library", "env_step_team_library",
             "physics_step_team_library", "fused_unroll_team_library")


@contextlib.contextmanager
def cli_spies(B: int, run12: bool):
    """The counts of a training CLI run, over exactly the ``with`` block:
    the team kernels' launches (K3, K2, K1, K4) and the one-thread
    kernels', each team launch by the body it went through (``(library,
    model variant)``), and for run12 (the curriculum) the difficulty before
    each training step's unrolls (the fast lane's, or the standard lane's
    on the ``B`` training envs). Yields the record it fills."""
    from puppax_torch.env import fused_unroll, soa_env
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.kernels import build
    from puppax_torch.physics import soa
    from puppax_torch.train import acting

    rec = {"seen": [], "by_body": {}}
    real = {"lane": FastLane.unroll, "standard": acting.generate_unroll}

    def lib_spy(name):
        lib = real[name] = getattr(build, name)

        def spy(s_, *a, **kw):  # each launch looks its library up
            key = (name, build.model_variant(s_))
            rec["by_body"][key] = rec["by_body"].get(key, 0) + 1
            return lib(s_, *a, **kw)

        return spy

    def lane_spy(self, state, *a, **kw):
        rec.setdefault("first_unroll", time.time())
        if run12:
            rec["seen"].append(float(state.info["difficulty"][0]))
        return real["lane"](self, state, *a, **kw)

    def standard_spy(env_, state, *a, **kw):
        if state.qpos.shape[0] == B:
            rec.setdefault("first_unroll", time.time())
        if run12 and state.qpos.shape[0] == B:  # the training env's unrolls
            rec["seen"].append(float(state.info["difficulty"][0]))
        return real["standard"](env_, state, *a, **kw)

    soa_env.wrapped_step.launches = soa_env.wrapped_step_one_thread.launches = 0
    soa_env.env_step.launches = soa_env.env_step_one_thread.launches = 0
    soa.step_batched.launches = soa.step_batched_one_thread.launches = 0
    fused_unroll.unroll.launches = fused_unroll.unroll_one_thread.launches = 0
    FastLane.unroll, acting.generate_unroll = lane_spy, standard_spy
    spies = {name: lib_spy(name) for name in TEAM_LIBS}
    for name, spy in spies.items():
        setattr(build, name, spy)
    try:
        yield rec
    finally:
        FastLane.unroll, acting.generate_unroll = real["lane"], real["standard"]
        for name in TEAM_LIBS:
            setattr(build, name, real[name])
        rec["launches"] = (soa_env.wrapped_step.launches, soa_env.env_step.launches,
                           soa.step_batched.launches, fused_unroll.unroll.launches)
        rec["one_thread"] = (soa_env.wrapped_step_one_thread.launches,
                             soa_env.env_step_one_thread.launches,
                             soa.step_batched_one_thread.launches,
                             fused_unroll.unroll_one_thread.launches)


def launched_cli(spec_path: str) -> None:
    """One rank of a training CLI run under ``torch.distributed.run``: the
    child ``cli_run(..., launcher=True)`` starts. It loads the libraries
    the parent built for the run's model (the spec's ``preload``: each
    key and ``.so`` under ``build/``) as the parent's in-process runs find
    them, then calls ``puppax_torch.scripts.train.main`` (what ``-m
    puppax_torch.scripts.train`` runs) on the spec's arguments inside
    ``cli_spies``, the process group joined by the CLI itself from the
    launcher's variables (its seconds timed), and writes the counts, the
    metrics, the collectives the learner issued (``parallel.mesh.calls``)
    and the group's backend, rank and world to the spec's ``out`` file."""
    t_child = time.time()
    with open(spec_path) as f:
        spec = json.load(f)
    import torch
    import torch.distributed as dist

    from puppax_torch.parallel import mesh as mesh_lib
    from puppax_torch.scripts import train as train_cli

    group = {}
    real_init = mesh_lib.maybe_initialize_distributed

    def timed_init(*a, **kw):
        t0 = time.perf_counter()
        started = real_init(*a, **kw)
        group.update(init_seconds=time.perf_counter() - t0, backend=str(dist.get_backend()),
                     rank=dist.get_rank(), world=dist.get_world_size())
        return started

    mesh_lib.maybe_initialize_distributed = timed_init
    import ctypes

    from puppax_torch.kernels import build

    kernels = {k.name: k for k in vars(build).values() if isinstance(k, build.Kernel)}
    for name, digest, config, path in spec.get("preload", []):
        lib = ctypes.CDLL(path)
        build._bind(lib, kernels[os.path.basename(path)[3:-3]], with_stream=True)
        build._LOADED[(name, digest, tuple(config))] = lib
    t_cli = time.time()
    with cli_spies(spec["B"], spec["run12"]) as rec:
        metrics = train_cli.main(spec["argv"])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    rec["times"] = {"child": t_child, "cli": t_cli, "first_unroll": rec.pop("first_unroll", None),
                    "end": time.time()}
    rec["by_body"] = [[name, variant, n] for (name, variant), n in rec["by_body"].items()]
    rec.update(metrics=metrics, calls=dict(mesh_lib.calls), group=group)
    with open(spec["out"], "w") as f:
        json.dump(rec, f)


class Phase:
    """Prints a phase's wall time when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)

    def __exit__(self, *exc):
        print(f"== {self.name}: {time.perf_counter() - self.t0:.1f} s wall", flush=True)
        return False


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of a training CLI run under torch.distributed.run (cli_run)
    ap.add_argument("--launched-cli", metavar="SPEC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device found (torch.cuda.is_available() is False); "
             "this script runs the port on an NVIDIA GPU")
    if not os.path.isfile(os.path.join(HERE, "puppax_torch", "__init__.py")):
        fail(f"no puppax_torch package beside {__file__}: run it from a checkout")
    sys.path.insert(0, HERE)
    if args.launched_cli:
        return launched_cli(args.launched_cli)

    from puppax_torch import random as prandom
    from puppax_torch.configs import DomainRandomizationConfig, EnvConfig, TrainConfig
    from puppax_torch.env import fused_unroll, soa_env
    from puppax_torch.env.domain_randomization import domain_randomize
    from puppax_torch.env.pupper import PupperV3Env
    from puppax_torch.env.rollout import FastLane
    from puppax_torch.env.wrappers import wrap_for_training
    from puppax_torch.kernels import build
    from puppax_torch.physics import pipeline, soa
    from puppax_torch.configs import experiment
    from puppax_torch.probes import common as probes
    from puppax_torch.model.tables import config_xml
    from puppax_torch.scripts import train as train_cli
    from puppax_torch.tools import eval as tools_eval
    from puppax_torch.tools import profiling
    from puppax_torch.train import acting, checkpoint, networks, ppo, running_statistics

    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # ---- the default training configuration, on the card ----
    env_cfg, dr_cfg, tc = EnvConfig(), DomainRandomizationConfig(), TrainConfig()
    B = tc.num_envs
    # ---- jax's threefry: the kernel every draw of the port goes through
    # (the DR and the resets below draw through it), then its checks ----
    with Phase("build threefry"):
        build.threefry_library()
        tf_build = build.last_build["threefry"]
        print(f"build: threefry, nvcc {tf_build['compile_seconds']:.1f} s, cached "
              f"{tf_build['cached']}", flush=True)
        for line in open(os.path.join(tf_build["dir"], "build.log")).read().splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print("  ptxas:" + line.split(":", 1)[-1].rstrip())
    # random inputs of the checks from a generator; the port's own draws
    # (resets, DR, networks, unrolls) from jax keys split off one chain
    g = torch.Generator(device=device).manual_seed(args.seed)
    with Phase("threefry vs plain"):
        tf = threefry_checks(device, g)
    key_chain = [prandom.key(args.seed, device)]

    def next_key():
        key_chain[0], k = prandom.split(key_chain[0]).unbind(0)
        return k

    def env_keys(n):
        return prandom.split(next_key(), n)

    env = PupperV3Env.from_config(env_cfg, device=device)
    os.environ["PUPPAX_SOA_ENV"] = "off"  # read at construction: the physics-only lane
    try:
        env_po = PupperV3Env.from_config(env_cfg, device=device)
    finally:
        del os.environ["PUPPAX_SOA_ENV"]
    ranges = {k: v for k, v in vars(dr_cfg).items() if k != "enabled"}

    def randomization_fn(m, keys):
        return domain_randomize(m, keys, **ranges)

    wrapped = wrap_for_training(env, tc.episode_length, randomization_fn=randomization_fn,
                                randomization_keys=env_keys(B))
    nets = networks.make_ppo_networks(
        env.observation_size, env.action_size, tc.policy_hidden_layer_sizes,
        tc.value_hidden_layer_sizes, tc.activation, device=device, key=next_key(),
    )
    normalizer = running_statistics.init_state(env.observation_size, device=device)
    params = (normalizer, nets.policy_network)
    lane = FastLane(wrapped)
    s, es, n_sub, L = env._s, env._es, env._n_substeps, tc.episode_length
    # run12's env (history 4, privileged obs, the gait clock, the curriculum)
    # at full width, with the default DR
    with open(os.path.join(HERE, RUN12_CONFIG)) as f:
        cfg12 = experiment.from_dict(json.load(f))
    env12 = PupperV3Env.from_config(cfg12.env, device=device)
    wrapped12 = wrap_for_training(env12, L, randomization_fn=randomization_fn,
                                randomization_keys=env_keys(B))
    lane12 = FastLane(wrapped12)
    s12, es12, tc12 = env12._s, env12._es, cfg12.train
    if cfg12.train.episode_length != L or cfg12.env.environment_timestep != env_cfg.environment_timestep:
        raise AssertionError("run12's episode and env step differ from the default's")
    rec12 = {  # the run12 bodies' build records
        "team K3[run12]": build.record_name(build.WRAPPED_STEP_TEAM, build.env_variant(es12)),
        "K3[run12]": build.record_name(build.WRAPPED_STEP, build.env_variant(es12)),
        "team K2[hist4]": build.record_name(build.ENV_STEP_TEAM, build.env_variant(es12, False)),
        "team K4[run12]": build.record_name(build.FUSED_UNROLL_TEAM, build.env_variant(es12)),
        "K4[run12]": build.record_name(build.FUSED_UNROLL, build.env_variant(es12)),
    }
    # run9's env (the heightfield, from its committed tables), with the default DR
    with open(os.path.join(HERE, RUN9_CONFIG)) as f:
        cfg9 = experiment.from_dict(json.load(f))
    env9 = PupperV3Env.from_config(cfg9.env, device=device)
    wrapped9 = wrap_for_training(env9, L, randomization_fn=randomization_fn,
                                randomization_keys=env_keys(B))
    lane9 = FastLane(wrapped9)
    s9, es9, tc9 = env9._s, env9._es, cfg9.train
    if tc9.episode_length != L or cfg9.env.environment_timestep != env_cfg.environment_timestep:
        raise AssertionError("run9's episode and env step differ from the default's")
    hf = build.model_variant(s9)
    rec9 = {  # run9's bodies' build records
        "team K1[hfield]": build.record_name(build.PHYSICS_STEP_TEAM, hf),
        "K1[hfield]": build.record_name(build.PHYSICS_STEP, hf),
        "team K2[hfield]": build.record_name(build.ENV_STEP_TEAM, hf),
        "K2[hfield]": build.record_name(build.ENV_STEP, hf),
        "team K3[hfield]": build.record_name(build.WRAPPED_STEP_TEAM, hf),
        "K3[hfield]": build.record_name(build.WRAPPED_STEP, hf),
        "team K4[hfield]": build.record_name(build.FUSED_UNROLL_TEAM, hf),
        "K4[hfield]": build.record_name(build.FUSED_UNROLL, hf),
    }
    # run8's env (20 boxes, from its committed tables), with the default DR
    with open(os.path.join(HERE, RUN8_CONFIG)) as f:
        cfg8 = experiment.from_dict(json.load(f))
    env8 = PupperV3Env.from_config(cfg8.env, device=device)
    wrapped8 = wrap_for_training(env8, L, randomization_fn=randomization_fn,
                                randomization_keys=env_keys(B))
    lane8 = FastLane(wrapped8)
    s8, es8, tc8 = env8._s, env8._es, cfg8.train
    if tc8.episode_length != L or cfg8.env.environment_timestep != env_cfg.environment_timestep:
        raise AssertionError("run8's episode and env step differ from the default's")
    bx = build.model_variant(s8)
    rec8 = {  # run8's bodies' build records (the default lane's)
        "team K3[boxes]": build.record_name(build.WRAPPED_STEP_TEAM, bx),
        "K3[boxes]": build.record_name(build.WRAPPED_STEP, bx),
        "team K2[boxes]": build.record_name(build.ENV_STEP_TEAM, bx),
        "team K1[boxes]": build.record_name(build.PHYSICS_STEP_TEAM, bx),
        "team K4[boxes]": build.record_name(build.FUSED_UNROLL_TEAM, bx),
    }
    # the capsule-legged Pupper (the bundled model's foot spheres as
    # capsules, bench.py's capsule variant) from a file, through env.path
    # and its committed tables, with the default DR
    caps_path = capsule_xml_file()
    env_c = PupperV3Env.from_config(replace(env_cfg, path=caps_path), device=device)
    wrapped_c = wrap_for_training(env_c, L, randomization_fn=randomization_fn,
                                randomization_keys=env_keys(B))
    lane_c = FastLane(wrapped_c)
    sc, esc = env_c._s, env_c._es
    cv = build.model_variant(sc)
    recc = {  # the capsule model's team bodies' build records
        "K3": build.record_name(build.WRAPPED_STEP_TEAM, cv),
        "K2": build.record_name(build.ENV_STEP_TEAM, cv),
        "K1": build.record_name(build.PHYSICS_STEP_TEAM, cv),
        "K4": build.record_name(build.FUSED_UNROLL_TEAM, cv),
    }
    s1 = env_po._cv_step.s  # K1's static digest (the physics-only env's step)
    print(f"config: envs {B}, substeps {n_sub}, episode {L}, unroll {T_UNROLL}, "
          f"obs {env.observation_size}, policy {tc.policy_hidden_layer_sizes}, "
          f"value {tc.value_hidden_layer_sizes}, batch {tc.batch_size} x "
          f"{tc.num_minibatches}, updates {tc.num_updates_per_batch}, eval envs "
          f"{EVAL_ENVS}, DR on", flush=True)

    def print_build(kname, label):
        """A build's record: lines, operations, seconds, the team schedule's
        numbers and ptxas's."""
        info = build.last_build[kname]
        print(f"build: {label} {kname}, {info['lines']} generated lines, "
              f"{info['ops_per_env']} float ops per env, generate "
              f"{info['generate_seconds']:.1f} s, nvcc {info['compile_seconds']:.1f} s, "
              f"cached {info['cached']}", flush=True)
        if "warps" in info:
            print(f"  team: {info['warps']} warps per block, heaviest stream "
                  f"{max(info['stream_ops'])} float ops per env, {info['replicated_ops']} "
                  f"replicated in all, {info['barriers']} barriers, "
                  f"{info['shared_bytes']} bytes of shared memory ({info['slots']} slots, "
                  f"write gap {info['write_gap']})" + (
                      f", {info['scratch_bytes_per_env']} bytes of global scratch per env"
                      if "scratch_bytes_per_env" in info else ""), flush=True)
        log_path = os.path.join(info["dir"], "build.log")
        for line in open(log_path).read().splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print("  ptxas:" + line.split(":", 1)[-1].rstrip())

    # ---- build the default's eight kernels: their bodies rendered in a
    # pool of processes, one nvcc process per kernel as its body lands ----
    with Phase("build team K3 + team K2 + team K1 + team K4 + K3 + K2 + K1 + K4"):
        batch = [(build.wrapped_step_team_library, (s, es, n_sub, L)),
                 (build.env_step_team_library, (s, es, n_sub)),
                 (build.physics_step_team_library, (s1, n_sub)),
                 (build.fused_unroll_team_library, (s, es, n_sub, L)),
                 (build.wrapped_step_library, (s, es, n_sub, L)),
                 (build.env_step_library, (s, es, n_sub)),
                 (build.physics_step_library, (s1, n_sub)),
                 (build.fused_unroll_library, (s, es, n_sub, L))]
        t_batch = time.perf_counter()
        build.build_batch(*batch)
        first_batch_s = time.perf_counter() - t_batch
        print(f"{len(batch)} bodies rendered in a pool of {min(len(batch), os.cpu_count())} "
              f"processes, each nvcc started as its body landed", flush=True)
        for kname, label in (("wrapped_step_team", "team K3"), ("env_step_team", "team K2"),
                             ("physics_step_team", "team K1"), ("fused_unroll_team", "team K4"),
                             ("wrapped_step", "K3"), ("env_step", "K2"), ("physics_step", "K1"),
                             ("fused_unroll", "K4")):
            print_build(kname, label)

    # ---- the other kernels, built in the background behind the phases
    # below (their host-bound times run beside the builds), render
    # processes and compilers niced so those phases keep their CPU; one
    # batch after another, each awaited before the first phase that needs
    # it: run12's five bodies (run12's phases), run9's and run8's thirteen
    # (run9's; a batch lasts at least its slowest nvcc, ~200 s for a box
    # body, so the two terrains share one), the capsule model's four (its
    # phases), the probes' 30 libraries (the probes) ----
    from puppax_torch.probes import probe_degradation, probe_fma_fusion, probe_launch_overhead
    from puppax_torch.probes import profile_boundary, profile_kernel_phases, profile_layout
    from puppax_torch.probes import profile_overhead, profile_scan
    from puppax_torch.probes import pallas_soa_probe as soa_probe
    from puppax_torch.probes import pallas_spd_poc as spd_probe

    copy_names = ("copy_q", "copy_min", "copy_full", "copy_full_one_block")
    build.nice = 19
    background12 = build.start_batch(
        (build.wrapped_step_team_library, (s12, es12, n_sub, L)),
        (build.wrapped_step_library, (s12, es12, n_sub, L)),
        (build.env_step_team_library, (s12, es12, n_sub)),
        (build.fused_unroll_team_library, (s12, es12, n_sub, L)),
        (build.fused_unroll_library, (s12, es12, n_sub, L)))
    background98 = build.start_batch(
        (build.physics_step_team_library, (s9, n_sub)),
        (build.physics_step_library, (s9, n_sub)),
        (build.env_step_team_library, (s9, es9, n_sub)),
        (build.env_step_library, (s9, es9, n_sub)),
        (build.wrapped_step_team_library, (s9, es9, n_sub, L)),
        (build.wrapped_step_library, (s9, es9, n_sub, L)),
        (build.fused_unroll_team_library, (s9, es9, n_sub, L)),
        (build.fused_unroll_library, (s9, es9, n_sub, L)),
        (build.wrapped_step_team_library, (s8, es8, n_sub, L)),
        (build.wrapped_step_library, (s8, es8, n_sub, L)),
        (build.env_step_team_library, (s8, es8, n_sub)),
        (build.physics_step_team_library, (s8, n_sub)),
        (build.fused_unroll_team_library, (s8, es8, n_sub, L)),
        after=background12)
    background_c = build.start_batch(
        (build.wrapped_step_team_library, (sc, esc, n_sub, L)),
        (build.env_step_team_library, (sc, esc, n_sub)),
        (build.physics_step_team_library, (sc, n_sub)),
        (build.fused_unroll_team_library, (sc, esc, n_sub, L)),
        after=background98)
    background_probes = build.start_batch(
        *[(build.probe_physics_library, (s1, n_sub, cut)) for cut in soa.PHASES],
        *[(build.probe_physics_team_library, (s1, n_sub, cut)) for cut in soa.PHASES],
        (build.probe_physics_library, (s1, n_sub, None, True)),
        (build.probe_physics_team_library, (s1, n_sub, None, True)),
        (build.fma_chain_library, (False,)), (build.fma_chain_library, (True,)),
        (build.fma_chain_ilp_library, (False,)), (build.fma_chain_ilp_library, (True,)),
        (build.add_one_library, ()), (build.add_one_pdl_library, ()),
        (build.probe_copy_library, ()), (soa_probe.library, ()),
        (soa_probe.library, (soa_probe.ROUNDS, True)), (build.probe_spd_library, ()),
        (build.probe_spd_warp_library, ()), (profile_overhead.fk_team_library, (s1, n_sub)),
        after=background_c)
    print("in the background (niceness 19), one batch after another: run12's 5 bodies, "
          "run9's and run8's 13, the capsule model's 4, the probes' 30 libraries", flush=True)

    # ---- team K3 and the one-thread K3 against plain at 4096, 128 and 130 envs ----
    def k3_check(name, s_, es_, blocks_, limit, warm=WARM_STEPS, times=None, wider=None):
        """Team K3 and the one-thread K3 against the plain version on the
        same inputs (at most ``limit`` envs outside tolerance) and against
        each other bit for bit. Some env must touch the floor, and where the
        env has privileged rows, some env must be done and every done env's
        privileged rows must be its ``first`` block's. ``wider`` (a list
        holding the plain outputs of a wider check whose first envs are
        these blocks) stands in for a plain run: each env's rows are its
        own, so its first columns are the plain version on these blocks.
        Returns (team's max abs err, the one-thread's); with ``times`` (a
        list), appends the plain version's milliseconds there, and with
        ``wider`` empty, puts the plain outputs into it."""
        n_envs = blocks_[0].shape[1]
        aux = soa_env.aux_row_map(es_)
        got = soa_env.wrapped_step(s_, es_, n_sub, L, *blocks_)
        one = soa_env.wrapped_step_one_thread(s_, es_, n_sub, L, *blocks_)
        torch.cuda.synchronize()
        if wider:
            want = [w_[:, :n_envs] for w_ in wider[0]]
        else:
            want, plain_ms = timed_once(lambda: soa_env.wrapped_step_rows(s_, es_, n_sub, L,
                                                                          *blocks_))
            if times is not None:
                times.append(plain_ms)
            if wider is not None:
                wider.append(want)
        per_block, differing, err = compare_outputs(s_, es_, aux, got, want)
        _, one_differing, one_err = compare_outputs(s_, es_, aux, one, want)
        bits_err, bits_envs = probes.compare_exact(got, one)
        c0, cn = es_.env_rows["last_contact"]
        in_contact = int((got[2][c0 : c0 + cn] > 0.5).any(0).sum())
        restored, restore_note = True, ""
        if "privileged" in aux:
            done = got[3][1] > 0.5
            r0, n = aux["privileged"]
            f0 = s_.nq + s_.nv + es_.hist
            restored = bool(done.any()) and torch.equal(got[4][r0 : r0 + n][:, done],
                                                        blocks_[6][f0 : f0 + n][:, done])
            restore_note = (f"; {int(done.sum())} envs done, their privileged rows restored: "
                            f"{restored}")
        print(f"team {name} vs plain at {n_envs} envs after {warm} kernel steps "
              f"({in_contact} envs with a foot on the floor): max abs err per block "
              + json.dumps(per_block) + f"; {len(differing)} envs outside tolerance; "
              f"one-thread {name} vs plain: max abs err {one_err!r}, {len(one_differing)} "
              f"outside tolerance; team {name} vs one-thread {name} (bit for bit): {bits_envs} "
              f"envs differ, max abs err {bits_err!r}" + restore_note, flush=True)
        for b, what in differing + one_differing:
            print(f"  env {b} differs: {what}")
        if len(differing) > limit or len(one_differing) > limit:
            raise AssertionError(f"{len(differing)} (team) and {len(one_differing)} "
                                 f"(one-thread) of {n_envs} envs differ (limit {limit})")
        if (bits_envs, bits_err) != (0, 0.0):
            raise AssertionError(f"team {name} and the one-thread {name} differ: the same "
                                 "program must give the same bits")
        if in_contact == 0:
            raise AssertionError("no env touches the floor: the contact path went unchecked")
        if not restored:
            raise AssertionError(f"{name}: no env done, or the done envs' privileged rows "
                                 "are not their first block's")
        return err, one_err

    with Phase("K3 vs plain"):
        state = wrapped.reset(env_keys(B))
        state, _ = lane.unroll(state, params, next_key(), WARM_STEPS)
        carry = lane.carry_from_state(state)
        export_obs = state.obs[:EXPORT_OBS].clone()  # raw observations for the export phase
        _, noise, _ = lane.draw_noise_block(env_keys(B), 1)
        eps = torch.randn((env.action_size, B), generator=g, device=device)
        r0, n = es.env_rows["obs_history"]
        with torch.no_grad():
            act, _, _ = lane.policy_rows(normalizer, nets.policy_network)(
                carry["env"][r0 : r0 + n], eps)
        blocks = [carry["q"], carry["v"], act, carry["env"], noise[0].contiguous(),
                  carry["dr"], carry["first"], carry["wrap"]]
        k3_err, k3_one_err, k3_plain_ms, wide = 0.0, 0.0, [], []
        for n_envs in (B, EVAL_ENVS, EVAL_ENVS + 2):  # 128 and 130 against the 4096 plain run
            ins = blocks if n_envs == B else [x[:, :n_envs].contiguous() for x in blocks]
            err, one_err = k3_check("K3", s, es, ins, MAX_DIFFERING_ENVS,
                                    times=k3_plain_ms if n_envs == B else None, wider=wide)
            k3_err, k3_one_err = max(k3_err, err), max(k3_one_err, one_err)

        def k3_step():
            soa_env.wrapped_step(s, es, n_sub, L, *blocks)

        def k3_one():
            soa_env.wrapped_step_one_thread(s, es, n_sub, L, *blocks)

        k3_one_ms = [cuda_ms(k3_one, 20)]
        k3_ms = [cuda_ms(k3_step, 20), cuda_ms(k3_step, 20)]
        k3_one_ms.append(cuda_ms(k3_one, 20))
        print(f"team K3 step at {B} envs: {statistics.median(k3_ms):.4f} ms (runs {k3_ms}); "
              f"one-thread K3 {statistics.median(k3_one_ms):.4f} ms (runs {k3_one_ms}); A/B K3, "
              f"one-thread / team: {statistics.median(k3_one_ms) / statistics.median(k3_ms):.3f}x; "
              f"plain {statistics.median(k3_plain_ms):.1f} ms (runs {k3_plain_ms})", flush=True)

    # ---- K4 against plain: T=4 steps from the K3 check's states ----
    aux_rows = soa_env.aux_row_map(es)
    activation = tc.activation
    layers = fused_unroll.fold_normalizer(normalizer, nets.policy_network)

    def k4_blocks(lane_, carry_, n_envs, T):
        _, noise_, _ = lane_.draw_noise_block(env_keys(n_envs), T)
        eps_ = torch.randn((T, env.action_size, n_envs), generator=g, device=device)
        return [carry_["q"], carry_["v"], carry_["env"], carry_["wrap"], carry_.get("phase"),
                carry_["first"], carry_["dr"], noise_, eps_]

    def k4_check(label, s_, es_, layers_, k4_in, limit):
        """Team K4 and the one-thread K4 against the plain version on the
        same inputs (``compare_unroll``, at most ``limit`` envs outside
        tolerance), and against each other bit for bit. Returns (team's max
        abs err, the one-thread's, the plain version's ms, the plain
        outputs)."""
        n_envs, T = k4_in[0].shape[1], k4_in[-1].shape[0]
        aux_rows = soa_env.aux_row_map(es_)
        got = fused_unroll.unroll(s_, es_, n_sub, L, activation, layers_, *k4_in)
        one = fused_unroll.unroll_one_thread(s_, es_, n_sub, L, activation, layers_, *k4_in)
        torch.cuda.synchronize()
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(fused_unroll.unroll_rows(
            s_, es_, n_sub, L, activation, layers_, *k4_in)), 1)
        want = plain[0]
        per_block, differing, err = compare_unroll(s_, es_, aux_rows, got, want)
        _, one_differing, one_err = compare_unroll(s_, es_, aux_rows, one, want)
        flat = [x.reshape(-1, n_envs) for x in want if x is not None]
        _, bits = probes.compare_exact([x.reshape(-1, n_envs) for x in got if x is not None], flat)
        _, one_bits = probes.compare_exact([x.reshape(-1, n_envs) for x in one if x is not None],
                                           flat)
        print(f"team K4 vs plain {label}: max abs err per block " + json.dumps(per_block)
              + f"; {len(differing)} envs outside tolerance, {bits} not bit for bit; one-thread "
              f"K4 vs plain: max abs err {one_err!r}, {len(one_differing)} outside tolerance, "
              f"{one_bits} not bit for bit", flush=True)
        for b, what in differing + one_differing:
            print(f"  env {b} differs: {what}")
        if len(differing) > limit or len(one_differing) > limit:
            raise AssertionError(f"{len(differing)} (team) and {len(one_differing)} (one-thread) "
                                 f"of {n_envs} envs differ (limit {limit})")
        if not all((g is None and o is None) or torch.equal(g, o) for g, o in zip(got, one)):
            raise AssertionError("team K4 and the one-thread K4 differ: the same program must "
                                 "give the same bits")
        return err, one_err, plain_ms, want

    with Phase("K4 vs plain"):
        k4_check_in = k4_blocks(lane, carry, B, T_PLAIN)
        k4_err, k4_one_err, k4_plain_ms, want = k4_check(
            f"at {B} envs x T={T_PLAIN} from the K3 check's states", s, es, layers, k4_check_in,
            MAX_DIFFERING_ENVS)
        done_steps = int((want[9][:, aux_rows["done"][0]] > 0.5).sum())
        print(f"  ({done_steps} env-steps ending an episode)", flush=True)

        # the gait clock on: 128 envs of the nominal model, clocks apart,
        # every third env reaching the episode limit at the last step, so
        # its clock restarts
        env_gait = PupperV3Env.from_config(replace(env_cfg, gait_phase_observation=True),
                                           device=device)
        gait_wrapped = wrap_for_training(env_gait, L)
        gstate = gait_wrapped.reset(env_keys(EVAL_ENVS))
        gsteps = torch.zeros(EVAL_ENVS, device=device)
        gsteps[::3] = L - T_PLAIN
        gstate = gstate.replace(info=dict(
            gstate.info, steps=gsteps, gait_phase=torch.linspace(0.5, 6.27, EVAL_ENVS,
                                                                 device=device)))
        gait_lane = FastLane(gait_wrapped)
        gait_nets = networks.make_ppo_networks(
            env_gait.observation_size, env.action_size, tc.policy_hidden_layer_sizes,
            tc.value_hidden_layer_sizes, tc.activation, device=device, key=next_key(),
        )
        gait_layers = fused_unroll.fold_normalizer(None, gait_nets.policy_network)
        g_in = k4_blocks(gait_lane, gait_lane.carry_from_state(gstate), EVAL_ENVS, T_PLAIN)
        k4_gait_err, k4_one_gait_err, _, want = k4_check(
            f"with the gait clock at {EVAL_ENVS} envs x T={T_PLAIN}", env_gait._s, env_gait._es,
            gait_layers, g_in, 0)
        restarts = int((want[4] == 0).sum())
        print(f"  ({restarts} clocks restarted)", flush=True)
        if restarts == 0:
            raise AssertionError("no clock restarted: the done restore went unchecked")
        k4_err, k4_one_err = max(k4_err, k4_gait_err), max(k4_one_err, k4_one_gait_err)

        # both K4s per T=4 unroll (the kernels line's unit) and per T=20
        # unroll at 4096 envs from the check's states, in turns
        k4_in = k4_blocks(lane, carry, B, T_CHECK)
        k4_in_long = k4_blocks(lane, carry, B, T_UNROLL)

        def k4_unroll(ins):
            return lambda: fused_unroll.unroll(s, es, n_sub, L, activation, layers, *ins)

        def k4_one_unroll(ins):
            return lambda: fused_unroll.unroll_one_thread(s, es, n_sub, L, activation, layers,
                                                          *ins)

        k4_one_ms = [cuda_ms(k4_one_unroll(k4_in), 5)]
        k4_ms = [cuda_ms(k4_unroll(k4_in), 5), cuda_ms(k4_unroll(k4_in), 5)]
        k4_one_ms.append(cuda_ms(k4_one_unroll(k4_in), 5))
        k4_long_one_ms = [cuda_ms(k4_one_unroll(k4_in_long), 3)]
        k4_long_ms = [cuda_ms(k4_unroll(k4_in_long), 3), cuda_ms(k4_unroll(k4_in_long), 3)]
        k4_long_one_ms.append(cuda_ms(k4_one_unroll(k4_in_long), 3))
        for T, team_ms, one_ms, plain in ((T_CHECK, k4_ms, k4_one_ms,
                                           f"; plain {k4_plain_ms:.1f} ms per T={T_PLAIN} "
                                           f"unroll"),
                                          (T_UNROLL, k4_long_ms, k4_long_one_ms, "")):
            print(f"team K4 per T={T} unroll at {B} envs: {statistics.median(team_ms):.4f} ms "
                  f"(runs {team_ms}), {statistics.median(team_ms) / T:.4f} ms per step; "
                  f"one-thread K4 {statistics.median(one_ms):.4f} ms (runs {one_ms}); A/B "
                  f"K4, one-thread / team: "
                  f"{statistics.median(one_ms) / statistics.median(team_ms):.3f}x" + plain,
                  flush=True)

    # ---- K1 against plain, and against the torch pipeline, at 4096 envs ----
    with Phase("K1 vs plain"):
        # the K3 check's DR'd states under the policy's motor targets
        dev = env_po._dev
        ctrl = (dev["default_pose"][:, None] + es.action_scale * act)
        ctrl = torch.minimum(torch.maximum(ctrl, dev["lowers"][:, None]),
                             dev["uppers"][:, None]).contiguous()
        k1_blocks = [carry["q"], carry["v"], ctrl, carry["dr"]]
        got = soa.step_batched(s1, *k1_blocks, n_sub)
        one = soa.step_batched_one_thread(s1, *k1_blocks, n_sub)
        torch.cuda.synchronize()
        want, k1_plain_ms = timed_once(lambda: soa.physics_step_rows(s1, n_sub, *k1_blocks))
        k1_plain_ms = [k1_plain_ms]
        per_block, differing, k1_err = compare_physics_outputs(s1, got, want)
        _, _, k1_one_err = compare_physics_outputs(s1, one, want)
        r0, n = s1.cache_rows["con_dist"]
        counts = torch.stack([(got[2][r0 : r0 + n][[i for i, p in enumerate(s1.pairs)
                                                     if p.kind == kind]] < 0).sum(0)
                              for kind in ("ps", "ss")], 1)
        print(f"team K1 vs plain at {B} envs ({int((counts[:, 0] > 0).sum())} envs with a "
              f"foot on the floor): max abs err per block " + json.dumps(per_block)
              + f"; one-thread K1 vs plain: max abs err {k1_one_err!r}", flush=True)
        for b, what in differing:
            print(f"  env {b} differs: {what}")
        if len(differing) > MAX_DIFFERING_ENVS:
            raise AssertionError(f"{len(differing)} envs differ (limit {MAX_DIFFERING_ENVS})")
        if int((counts[:, 0] > 0).sum()) == 0:
            raise AssertionError("no env touches the floor: the contact path went unchecked")

        k1_small = [x[:, :EVAL_ENVS].contiguous() for x in k1_blocks]
        got_small = soa.step_batched(s1, *k1_small, n_sub)
        one_small = soa.step_batched_one_thread(s1, *k1_small, n_sub)
        torch.cuda.synchronize()
        want_small = [w[:, :EVAL_ENVS] for w in want]  # the 4096 plain run's first envs
        _, differing_small, k1_err_small = compare_physics_outputs(s1, got_small, want_small)
        _, _, k1_one_err_small = compare_physics_outputs(s1, one_small, want_small)
        print(f"team K1 vs plain at {EVAL_ENVS} envs: max abs err {k1_err_small!r}; one-thread "
              f"K1 vs plain: {k1_one_err_small!r}", flush=True)
        if len(differing_small) > MAX_DIFFERING_ENVS:
            raise AssertionError(f"{len(differing_small)} envs differ at {EVAL_ENVS} envs")
        if not all(torch.equal(a, b) for a, b in [*zip(got, one), *zip(got_small, one_small)]):
            raise AssertionError("team K1 and the one-thread K1 differ: the same program "
                                 "must give the same bits")

        def k1_step():
            soa.step_batched(s1, *k1_blocks, n_sub)

        def k1_step_small():
            soa.step_batched(s1, *k1_small, n_sub)

        def k1_one():
            soa.step_batched_one_thread(s1, *k1_blocks, n_sub)

        def k1_one_small():
            soa.step_batched_one_thread(s1, *k1_small, n_sub)

        k1_one_ms, k1_one_small_ms = [cuda_ms(k1_one, 20)], [cuda_ms(k1_one_small, 20)]
        k1_ms = [cuda_ms(k1_step, 20), cuda_ms(k1_step, 20)]
        k1_small_ms = [cuda_ms(k1_step_small, 20), cuda_ms(k1_step_small, 20)]
        k1_one_ms.append(cuda_ms(k1_one, 20))
        k1_one_small_ms.append(cuda_ms(k1_one_small, 20))
        print(f"team K1 step: {statistics.median(k1_ms):.4f} ms at {B} envs (runs {k1_ms}), "
              f"{statistics.median(k1_small_ms):.4f} ms at {EVAL_ENVS} envs (runs "
              f"{k1_small_ms}); plain {statistics.median(k1_plain_ms):.1f} ms at {B} envs "
              f"(runs {k1_plain_ms})", flush=True)
        print(f"one-thread K1 step: {statistics.median(k1_one_ms):.4f} ms at {B} envs (runs "
              f"{k1_one_ms}), {statistics.median(k1_one_small_ms):.4f} ms at {EVAL_ENVS} envs "
              f"(runs {k1_one_small_ms})", flush=True)
        ab = (statistics.median(k1_one_ms) / statistics.median(k1_ms),
              statistics.median(k1_one_small_ms) / statistics.median(k1_small_ms))
        print(f"A/B K1, one-thread / team: {ab[0]:.3f}x at {B} envs, {ab[1]:.3f}x at "
              f"{EVAL_ENVS} envs", flush=True)

    with Phase("K1 vs torch pipeline"):
        q0, v0 = carry["q"].t(), carry["v"].t()
        ps = pipeline.pipeline_step(wrapped.model, pipeline._zeros_state(wrapped.model, q0, v0),
                                    ctrl.t(), n_sub)
        ref = state_blocks(s1, ps)
        torch.cuda.synchronize()
        # held on qpos and qvel; the caches are reported (qacc, the solver's
        # output before the dt-scaled update, is the most sensitive row)
        tols = physics_tols(s1, ref)
        _, differing, pipe_err = _differing(("q", "v"), got[:2], ref[:2], tols)
        cache_err, cache_differing, _ = _differing(("caches",), got[2:], ref[2:], tols)
        pen = torch.maximum(counts, torch.stack([(ps.contact_dist[:, [
            i for i, p in enumerate(s1.pairs) if p.kind == kind]] < 0).sum(1)
            for kind in ("ps", "ss")], 1))
        m = env_po.model
        outside = (pen.amax(1) > m.max_geom_pairs) | (pen.sum(1) > m.max_contact_points)
        n_outside = int(outside.sum())
        in_cap = [b for b, _ in differing if not bool(outside[b])]
        explained = []
        if in_cap:
            idx = torch.tensor(in_cap, device=device)
            trips = (soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS)
            soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS = CONVERGED_LS_TRIPS
            try:
                conv = soa.physics_step_rows(s1, n_sub, *[x[:, idx].contiguous()
                                                          for x in k1_blocks])
            finally:
                soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS = trips
            sub_tols = {k: t[:, idx] for k, t in tols.items()}
            _, still, _ = _differing(("q", "v"), conv[:2], [x[:, idx] for x in ref[:2]],
                                     sub_tols)
            still_envs = {in_cap[i] for i, _ in still}
            explained = [b for b in in_cap if b not in still_envs]
        unexplained = len(differing) - n_outside_differing(differing, outside) - len(explained)
        print(f"K1 vs torch pipeline_step at {B} envs: {len(differing)} envs outside qpos "
              f"5e-5 / scaled qvel 5e-4 (max abs err {pipe_err!r}); of them "
              f"{n_outside_differing(differing, outside)} outside the MJX caps, "
              f"{len(explained)} in the caps that agree once the line search runs "
              f"{CONVERGED_LS_TRIPS} trips, {unexplained} else; {n_outside} envs outside the "
              f"caps in all", flush=True)
        for b, what in differing[:12]:
            print(f"  env {b} differs (outside the caps: {bool(outside[b])}, line search: "
                  f"{b in explained}): {what}")
        print(f"  the caches at K1-vs-plain tolerances: {len(cache_differing)} envs outside "
              f"(max abs err {cache_err['caches']!r}; outside the caps: "
              f"{n_outside_differing(cache_differing, outside)})", flush=True)
        for b, what in cache_differing[:12]:
            print(f"  env {b} caches differ: {what}")
        if unexplained > n_outside:
            raise AssertionError(f"{unexplained} envs differ from the torch pipeline beyond "
                                 f"the caps and the line search (limit {n_outside})")

    # ---- K2 against plain at the evaluator's 128 envs ----
    with Phase("K2 vs plain"):
        eval_wrapped = wrap_for_training(env, L)  # the nominal model, no DR
        estate = eval_wrapped.reset(env_keys(EVAL_ENVS), caches=True)
        for _ in range(WARM_STEPS):
            estate = eval_wrapped.step(
                estate, torch.rand((EVAL_ENVS, env.action_size), generator=g,
                                   device=device) * 2 - 1)
        in_contact = int(estate.info["last_contact"].any(1).sum())
        act = torch.rand((EVAL_ENVS, env.action_size), generator=g, device=device) * 2 - 1
        k2_noise = env.draw_step_noise(env_keys(EVAL_ENVS))
        k2_blocks = [soa_env.rows_block([estate.qpos]), soa_env.rows_block([estate.qvel]),
                     soa_env.rows_block([act]), soa_env.env_block(es, estate.info, estate.obs),
                     soa_env.noise_block(es, k2_noise), eval_wrapped.dr_rows(EVAL_ENVS)]
        got = soa_env.env_step(s, es, n_sub, *k2_blocks)
        one = soa_env.env_step_one_thread(s, es, n_sub, *k2_blocks)
        torch.cuda.synchronize()
        want, k2_plain_ms = timed_once(lambda: soa_env.env_step_rows(s, es, n_sub, *k2_blocks))
        per_block, differing, k2_err = compare_env_outputs(s, es, got, want)
        _, one_differing, k2_one_err = compare_env_outputs(s, es, one, want)
        print(f"team K2 vs plain at {EVAL_ENVS} envs after {WARM_STEPS} K2 steps "
              f"({in_contact} envs with a foot on the floor): max abs err per block "
              + json.dumps(per_block) + f"; one-thread K2 vs plain: max abs err "
              f"{k2_one_err!r}", flush=True)
        for b, what in differing + one_differing:
            print(f"  env {b} differs: {what}")
        if differing or one_differing:
            raise AssertionError(f"{len(differing)} (team) and {len(one_differing)} "
                                 f"(one-thread) of {EVAL_ENVS} envs differ (limit 0)")
        if in_contact == 0:
            raise AssertionError("no eval env touches the floor: the contact path went "
                                 "unchecked")
        # the training lane's 4096-env blocks (K3's first six)
        got_4096 = soa_env.env_step(s, es, n_sub, *blocks[:6])
        one_4096 = soa_env.env_step_one_thread(s, es, n_sub, *blocks[:6])
        torch.cuda.synchronize()
        want_4096 = soa_env.env_step_rows(s, es, n_sub, *blocks[:6])
        _, differing_4096, k2_err_4096 = compare_env_outputs(s, es, got_4096, want_4096)
        _, _, k2_one_err_4096 = compare_env_outputs(s, es, one_4096, want_4096)
        print(f"team K2 vs plain at {B} envs: max abs err {k2_err_4096!r}; one-thread K2 vs "
              f"plain: {k2_one_err_4096!r}", flush=True)
        if len(differing_4096) > MAX_DIFFERING_ENVS:
            raise AssertionError(f"{len(differing_4096)} envs differ at {B} envs")
        if not all(torch.equal(a, b) for a, b in [*zip(got, one), *zip(got_4096, one_4096)]):
            raise AssertionError("team K2 and the one-thread K2 differ: the same program "
                                 "must give the same bits")

        def k2_step():
            soa_env.env_step(s, es, n_sub, *k2_blocks)

        def k2_step_4096():
            soa_env.env_step(s, es, n_sub, *blocks[:6])

        def k2_one():
            soa_env.env_step_one_thread(s, es, n_sub, *k2_blocks)

        def k2_one_4096():
            soa_env.env_step_one_thread(s, es, n_sub, *blocks[:6])

        k2_one_ms, k2_one_4096_ms = [cuda_ms(k2_one, 20)], [cuda_ms(k2_one_4096, 20)]
        k2_ms = [cuda_ms(k2_step, 20), cuda_ms(k2_step, 20)]
        k2_4096_ms = [cuda_ms(k2_step_4096, 20), cuda_ms(k2_step_4096, 20)]
        k2_one_ms.append(cuda_ms(k2_one, 20))
        k2_one_4096_ms.append(cuda_ms(k2_one_4096, 20))
        print(f"team K2 step: {statistics.median(k2_ms):.4f} ms at {EVAL_ENVS} envs (runs "
              f"{k2_ms}), {statistics.median(k2_4096_ms):.4f} ms at {B} envs (runs "
              f"{k2_4096_ms}); plain {k2_plain_ms:.1f} ms at {EVAL_ENVS} envs", flush=True)
        print(f"one-thread K2 step: {statistics.median(k2_one_ms):.4f} ms at {EVAL_ENVS} envs "
              f"(runs {k2_one_ms}), {statistics.median(k2_one_4096_ms):.4f} ms at {B} envs "
              f"(runs {k2_one_4096_ms})", flush=True)
        ab = (statistics.median(k2_one_ms) / statistics.median(k2_ms),
              statistics.median(k2_one_4096_ms) / statistics.median(k2_4096_ms))
        print(f"A/B K2, one-thread / team: {ab[0]:.3f}x at {EVAL_ENVS} envs, {ab[1]:.3f}x at "
              f"{B} envs", flush=True)

    with Phase("physics-only step vs K2 step"):
        fused_step = env.step_from_draws(estate, act, k2_noise)
        po_step = env_po.step_from_draws(estate, act, k2_noise)
        torch.cuda.synchronize()
        errs = {name: float((getattr(po_step, name) - getattr(fused_step, name)).abs().max())
                for name in ("obs", "reward", "done")}
        print(f"physics-only env step (K1) vs K2 step at {EVAL_ENVS} envs: max abs err "
              + json.dumps(errs), flush=True)
        if errs["obs"] > 2e-4 or errs["reward"] > 2e-4 or errs["done"] != 0.0:
            raise AssertionError("the physics-only step differs from the K2 step")

    # ---- the rollout lane: FastLane.unroll, T=20, through K3 and through K4 ----
    def timed_unrolls(label):
        """One warm-up and N_UNROLLS timed unrolls from a fresh reset;
        checks the transitions; returns (median ms, (team K3 launches,
        one-thread K3 launches, team K4 launches, one-thread K4 launches))
        of the timed unrolls."""
        state = wrapped.reset(env_keys(B))
        state, _ = lane.unroll(state, params, next_key(), T_UNROLL)  # warm-up
        torch.cuda.synchronize()
        soa_env.wrapped_step.launches = soa_env.wrapped_step_one_thread.launches = 0
        fused_unroll.unroll.launches = fused_unroll.unroll_one_thread.launches = 0
        unroll_ms, datas = [], []
        for _ in range(N_UNROLLS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, data = lane.unroll(state, params, next_key(), T_UNROLL)
            end.record()
            torch.cuda.synchronize()
            unroll_ms.append(start.elapsed_time(end))
            datas.append(data)
        launches = (soa_env.wrapped_step.launches, soa_env.wrapped_step_one_thread.launches,
                    fused_unroll.unroll.launches, fused_unroll.unroll_one_thread.launches)
        med = statistics.median(unroll_ms)
        print(f"{label}: unroll T={T_UNROLL} x {B} envs: median {med:.3f} ms (runs {unroll_ms}), "
              f"{B * T_UNROLL / (med / 1000.0):.0f} env-steps/s", flush=True)
        key_d = next_key()
        draw_ms = [cuda_ms(lambda: (lane.draw_noise_block(state.info["rng"], T_UNROLL),
                                    lane.draw_eps(key_d, B, T_UNROLL)), 1) for _ in range(3)]
        print(f"{label}: the unroll's draws alone (draw_noise_block + draw_eps, T={T_UNROLL}, "
              f"threefry): median {statistics.median(draw_ms):.3f} ms (runs {draw_ms}), "
              f"{statistics.median(draw_ms) / med:.3f} of the unroll", flush=True)
        print(f"{label}: team K3 launches {launches[0]}, one-thread K3 launches {launches[1]}, "
              f"team K4 launches {launches[2]}, one-thread K4 launches {launches[3]} in the "
              f"{N_UNROLLS} unrolls", flush=True)
        for data in datas:
            if (data.observation.shape != (T_UNROLL, B, env.observation_size)
                    or data.action.shape != (T_UNROLL, B, env.action_size)):
                raise AssertionError(f"unroll shapes {tuple(data.observation.shape)}, "
                                     f"{tuple(data.action.shape)}")
            for name, x in (("obs", data.observation), ("reward", data.reward),
                            ("log_prob", data.policy_extras["log_prob"]),
                            ("next_obs", data.next_observation)):
                if not torch.isfinite(x).all():
                    raise AssertionError(f"non-finite {name} in the unroll")
            if not (data.action.abs() <= 1).all():
                raise AssertionError("an action outside [-1, 1]")
        done_frac = float(torch.stack([1.0 - d.discount for d in datas]).mean())
        truncs = int(torch.stack([d.truncation for d in datas]).sum())
        print(f"{label}: done fraction per step {done_frac:.5f}, truncations {truncs}",
              flush=True)
        if not 0.0 <= done_frac < 0.5 or truncs != 0:
            raise AssertionError("implausible episode ends for a fresh 1000-step episode")
        return med, launches

    with Phase("rollout lane"):
        k3_lane_ms, launches = timed_unrolls("K3 lane")
        if launches != (N_UNROLLS * T_UNROLL, 0, 0, 0):
            raise AssertionError(f"expected {N_UNROLLS * T_UNROLL} team K3 launches and no other, "
                                 f"got {launches}")

    with Phase("fused-unroll lane"):
        os.environ["PUPPAX_FUSED_UNROLL"] = "on"
        try:
            k4_lane_ms, launches = timed_unrolls("K4 lane")
        finally:
            del os.environ["PUPPAX_FUSED_UNROLL"]
        if launches != (0, 0, N_UNROLLS, 0):
            raise AssertionError(f"expected {N_UNROLLS} team K4 launches and no K3 or one-thread "
                                 f"K4, got {launches}")
        print(f"A/B, median unroll T={T_UNROLL} x {B} envs: K3 lane {k3_lane_ms:.3f} ms, K4 lane "
              f"{k4_lane_ms:.3f} ms (K4 / K3 {k4_lane_ms / k3_lane_ms:.3f})", flush=True)

    # ---- the main path: ppo.train, 3 training steps and 2 evaluations ----
    steps_per_train = tc.batch_size * tc.unroll_length * tc.num_minibatches
    n_train = math.ceil(TRAIN_TIMESTEPS / steps_per_train)
    unroll_steps = n_train * (tc.batch_size * tc.num_minibatches // B) * tc.unroll_length

    def zero_launch_counts():
        """Every production kernel wrapper's launch count (K1-K4, team and
        one-thread, and threefry) set to 0."""
        for wrapper in (soa_env.wrapped_step, soa_env.wrapped_step_one_thread,
                        soa_env.env_step, soa_env.env_step_one_thread, soa.step_batched,
                        soa.step_batched_one_thread, fused_unroll.unroll,
                        fused_unroll.unroll_one_thread, prandom.threefry):
            wrapper.launches = 0

    def train_and_check(environment, label, want, lane_line, n_evals=2):
        """One ppo.train run at the default configuration (3 training steps,
        ``n_evals`` evaluations: 2, before and after the training, or 1,
        after it); its kernel launches (team K3, K2, K1 and K4) against
        ``want`` and the one-thread K3's, K2's, K1's and K4's against none, its
        lane line against ``lane_line``, and the checks of the run. Returns
        the launches, the one-thread kernels' launches and the trained
        ``(normalizer, PPONetworkParams)``."""
        initial = {}

        def network_factory(obs_size, action_size, device=None, key=None):
            n = networks.make_ppo_networks(
                obs_size, action_size, tc.policy_hidden_layer_sizes,
                tc.value_hidden_layer_sizes, tc.activation, device=device,
                key=key, value_precision=tc.value_precision)
            initial["policy"] = copy.deepcopy(n.policy_network.state_dict())
            initial["value"] = copy.deepcopy(n.value_network.state_dict())
            return n

        progress = []
        ckpt_dir = tempfile.mkdtemp(prefix="puppax_torch_smoke_")
        zero_launch_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, (norm_out, params_out), _ = ppo.train(
                environment, num_timesteps=TRAIN_TIMESTEPS, episode_length=L, num_envs=B,
                num_eval_envs=EVAL_ENVS, learning_rate=tc.learning_rate,
                entropy_cost=tc.entropy_cost, discounting=tc.discounting,
                unroll_length=tc.unroll_length, batch_size=tc.batch_size,
                num_minibatches=tc.num_minibatches,
                num_updates_per_batch=tc.num_updates_per_batch,
                reward_scaling=tc.reward_scaling, clipping_epsilon=tc.clipping_epsilon,
                gae_lambda=tc.gae_lambda, normalize_observations=tc.normalize_observations,
                seed=args.seed, num_evals=n_evals, network_factory=network_factory,
                randomization_fn=randomization_fn,
                progress_fn=lambda step, m: progress.append((step, dict(m))),
                device=device, checkpoint_dir=ckpt_dir,
            )
        torch.cuda.synchronize()
        print(out.getvalue(), end="", flush=True)
        if lane_line not in out.getvalue():
            raise AssertionError(f"the lane line is not {lane_line!r}")
        launches = (soa_env.wrapped_step.launches, soa_env.env_step.launches,
                    soa.step_batched.launches, fused_unroll.unroll.launches)
        one_thread = (soa_env.wrapped_step_one_thread.launches,
                      soa_env.env_step_one_thread.launches, soa.step_batched_one_thread.launches,
                      fused_unroll.unroll_one_thread.launches)
        print(f"{label}: team K3 launches {launches[0]} (expected {want[0]}), team K2 launches "
              f"{launches[1]} (expected {want[1]}), team K1 launches {launches[2]} (expected "
              f"{want[2]}), team K4 launches {launches[3]} (expected {want[3]}); one-thread K3, "
              f"K2, K1 and K4 launches {one_thread} (expected (0, 0, 0, 0))", flush=True)
        if launches != want or one_thread != (0, 0, 0, 0):
            raise AssertionError("the training run did not launch the kernels as expected")
        threefry_launches[label] = prandom.threefry.launches
        print(f"{label}: threefry launches {prandom.threefry.launches} (every draw of the "
              f"resets, the DR, the networks' init, the unrolls, the SGD and the evaluations)",
              flush=True)
        if prandom.threefry.launches == 0:
            raise AssertionError("the training run drew nothing through the threefry kernel")
        tree = checkpoint.restore_checkpoint(os.path.join(ckpt_dir, "state"), map_location=device)
        if tree["env_steps"] != TRAIN_TIMESTEPS or float(norm_out.count) != TRAIN_TIMESTEPS:
            raise AssertionError(f"env steps {tree['env_steps']}, normalizer count "
                                 f"{float(norm_out.count)}, expected {TRAIN_TIMESTEPS}")
        updates = n_train * tc.num_updates_per_batch * tc.num_minibatches
        if tree["optimizer"]["count"] != updates:
            raise AssertionError(f"optimizer count {tree['optimizer']['count']}, "
                                 f"expected {updates}")
        for name, module in (("policy", params_out.policy), ("value", params_out.value)):
            sd = module.state_dict()
            if all(torch.equal(sd[k], initial[name][k]) for k in sd):
                raise AssertionError(f"the {name} parameters did not change")
            if any(not torch.equal(sd[k], tree["params"][name][k]) for k in sd):
                raise AssertionError(f"the checkpoint's {name} parameters differ from the "
                                     f"final state")
        for k, v in tree["params"]["normalizer"].items():
            if not torch.equal(v, getattr(norm_out, k)):
                raise AssertionError(f"the checkpoint's normalizer {k} differs")
        m = progress[-1][1]
        losses = {k: v for k, v in m.items() if k.endswith("_loss")}
        if len(losses) != 4 or not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"loss metrics {losses}")
        evals = [(step, mm) for step, mm in progress if "eval/episode_reward" in mm]
        if [step for step, _ in evals] != [0, TRAIN_TIMESTEPS][2 - n_evals:]:
            raise AssertionError(f"evaluations at {[step for step, _ in evals]}")
        for _, mm in evals:
            bad = [k for k, v in mm.items() if k.startswith("eval/") and not math.isfinite(v)]
            if bad or not 0 < mm["eval/avg_episode_length"] <= tc.episode_length:
                raise AssertionError(f"eval metrics {mm}")
        print(f"{label}: training/sps {m['training/sps']:.1f}, epoch "
              f"{m['training/walltime']:.3f} s for {n_train} training steps; per training "
              f"step: rollout {m['training/rollout_ms']:.3f} ms, reorder + normalizer "
              f"{m['training/prepare_ms']:.3f} ms, SGD {m['training/sgd_ms']:.3f} ms "
              f"(CUDA events)", flush=True)
        print(f"{label}: one evaluation " + ", ".join(
            f"at step {step}: {mm['eval/epoch_eval_time']:.3f} s wall" for step, mm in evals)
            + f"; final eval/episode_reward {m['eval/episode_reward']:.5f}, "
            f"eval/avg_episode_length {m['eval/avg_episode_length']:.1f}", flush=True)
        print(f"{label} losses " + json.dumps(losses), flush=True)
        return launches, one_thread, (norm_out, params_out)

    evals = 2 * tc.episode_length
    threefry_launches = {}
    with Phase("ppo.train"):
        launches, one_thread, trained = train_and_check(
            env, "ppo.train", (unroll_steps, evals, 0, 0),
            "rollout fast lane: ON (ok; devices=1, fused-unroll=OFF)")
        k3_launches, k2_launches = launches[:2]
        k3_one_launches, k2_one_launches = one_thread[:2]

    # the keys of the rank check at the end (its reset, networks and SGD),
    # split off the chain where the check ran before it was traced
    rank_keys = (env_keys(B), next_key(), next_key())

    # ---- visualize_policy on the trained policy: one env on the card, 560
    # steps of the 7-command script, each one team K2 launch ----
    with Phase("visualize_policy"):
        # team K2 and the one-thread K2 at B = 1 (a ragged 32-env block of one
        # env) bit for bit with the plain version on the card
        one_env = [x[:, :1].contiguous() for x in k2_blocks]
        want1 = soa_env.env_step_rows(s, es, n_sub, *one_env)
        for label, step_fn in (("team K2", soa_env.env_step),
                               ("one-thread K2", soa_env.env_step_one_thread)):
            got1 = step_fn(s, es, n_sub, *one_env)
            torch.cuda.synchronize()
            err1 = max(float((a - b).abs().max()) for a, b in zip(got1, want1))
            print(f"{label} vs plain at B = 1: max abs err {err1!r}", flush=True)
            if not all(torch.equal(a, b) for a, b in zip(got1, want1)):
                raise AssertionError(f"{label} at B = 1 is not the plain version bit for bit")
        vis_dir = tempfile.mkdtemp(prefix="puppax_torch_visualize_")
        last = []

        def vis_step(state, action):
            state = env.step(state, action)
            last[:] = [state.qpos]
            return state

        zero_launch_counts()
        timer = profiling.Timer()
        with timer.phase("visualize", fence=last):
            vis_ret = tools_eval.visualize_policy(
                TRAIN_TIMESTEPS, networks.make_inference_fn(nets), trained, env, vis_step,
                env.reset, vis_dir, n_steps=VIS_STEPS, render_every=2)
        vis_launches = {
            "team K2": soa_env.env_step.launches,
            "one-thread K2": soa_env.env_step_one_thread.launches,
            "team K1": soa.step_batched.launches,
            "one-thread K1": soa.step_batched_one_thread.launches,
            "team K3": soa_env.wrapped_step.launches,
            "one-thread K3": soa_env.wrapped_step_one_thread.launches,
            "team K4": fused_unroll.unroll.launches,
            "one-thread K4": fused_unroll.unroll_one_thread.launches,
            "threefry": prandom.threefry.launches}
        print(f"visualize_policy: {VIS_STEPS} steps of one env in "
              f"{timer.durations['visualize'][0]:.3f} s (host clock, fenced on the last qpos): "
              f"{timer.steps_per_sec('visualize', VIS_STEPS):.1f} env steps/s; launches "
              + json.dumps(vis_launches), flush=True)
        want_vis = {k: 0 for k in vis_launches if k != "threefry"}
        want_vis["team K2"] = VIS_STEPS
        if ({k: v for k, v in vis_launches.items() if k != "threefry"} != want_vis
                or vis_launches["threefry"] == 0):
            raise AssertionError(f"visualize_policy's launches {vis_launches}, expected "
                                 f"{want_vis} and threefry at least once")
        traj_path = os.path.join(vis_dir, f"step_{TRAIN_TIMESTEPS}_policy_trajectory.npz")
        with np.load(traj_path) as f:
            traj = {k: f[k] for k in f.files}
        script = np.repeat(tools_eval.command_script(0.5, 0.4, 1.5), VIS_STEPS // 7, axis=0)
        checks = {
            "qpos rows": traj["qpos"].shape == (VIS_STEPS + 1, s.nq),
            "finite": bool(np.isfinite(traj["qpos"]).all()),
            "the last row is the last step's": bool(np.array_equal(
                traj["qpos"][-1], last[0][0].cpu().numpy())),
            "commands": bool(np.array_equal(traj["commands"], script)),
            "fps 25": int(traj["fps"]) == 25,
            "mjcf": str(traj["mjcf"]) == config_xml(env_cfg),
        }
        try:
            import mujoco  # noqa: F401
            rendered = True
        except ImportError:  # the card's host: record only
            rendered = False
            checks["no video without mujoco"] = (vis_ret is None
                                                 and sorted(os.listdir(vis_dir))
                                                 == [os.path.basename(traj_path)])
        print(f"visualize_policy: trajectory file {os.path.getsize(traj_path)} bytes, qpos "
              f"{traj['qpos'].shape}, fps {int(traj['fps'])}, render_every "
              f"{int(traj['render_every'])}, returned {vis_ret!r} (mujoco "
              f"{'imports' if rendered else 'absent'}); checks " + json.dumps(checks),
              flush=True)
        if not all(checks.values()):
            raise AssertionError(f"the trajectory file fails {checks}")


    # ---- the export: the trained policy (and the gait-clock policy) to the
    # robot's JSON through the CLI, replayed by the native runtime ----
    with Phase("export"):
        # the gait-clock policy's normalizer: the trained run's statistics of
        # the 72 observation dims, then the clock's over the K4 check's 128
        # phases, so the raw observations lie in its range
        clock = running_statistics.update(running_statistics.init_state(2, device=device),
                                          gstate.obs[:, -2:])
        gait_norm = running_statistics.RunningStatisticsState(
            count=trained[0].count, **{f: torch.cat([getattr(trained[0], f), getattr(clock, f)])
                                       for f in ("mean", "summed_variance", "std")})
        for label, (norm_, nets_), gait in (
                ("the trained policy", trained, False),
                ("the gait-clock policy", (gait_norm, gait_nets.params), True)):
            export_and_replay(label, norm_, nets_, export_obs, env_gait if gait else env,
                              env_cfg, tc, device, gait)

    # ---- the physics-only lane: ppo.train under PUPPAX_SOA_ENV=off, one
    # evaluation (after the training) ----
    with Phase("ppo.train, physics-only lane"):
        os.environ["PUPPAX_SOA_ENV"] = "off"
        try:
            (_, _, k1_launches, _), (_, _, k1_one_launches, _), _ = train_and_check(
                env_po, "ppo.train physics-only", (0, 0, unroll_steps + evals // 2, 0),
                "rollout fast lane: OFF (PUPPAX_SOA_ENV=off; devices=1)", n_evals=1)
        finally:
            del os.environ["PUPPAX_SOA_ENV"]

    # ---- the fused-unroll lane: ppo.train under PUPPAX_FUSED_UNROLL=on, one
    # evaluation ----
    with Phase("ppo.train, fused-unroll lane"):
        os.environ["PUPPAX_FUSED_UNROLL"] = "on"
        try:
            (_, _, _, k4_launches), (_, _, _, k4_one_launches), _ = train_and_check(
                env, "ppo.train fused-unroll",
                (0, evals // 2, 0, unroll_steps // tc.unroll_length),
                "rollout fast lane: ON (ok; devices=1, fused-unroll=ON)", n_evals=1)
        finally:
            del os.environ["PUPPAX_FUSED_UNROLL"]

    # ---- run12: its bodies against their plain versions at full width ----
    with Phase("the background builds' end: run12's bodies"):
        libs = background12.result()
        print(f"{len(libs)} libraries built behind the default's phases", flush=True)
        for kname, label in ((v, k) for k, v in rec12.items()):
            print_build(kname, label)
    with Phase("run12 kernels vs plain"):
        nets12 = networks.make_ppo_networks(
            env12.observation_size, env12.action_size, tc12.policy_hidden_layer_sizes,
            tc12.value_hidden_layer_sizes, tc12.activation, device=device, key=next_key(),
            value_precision=tc12.value_precision, privileged_size=env12.privileged_obs_size)
        params12 = (None, nets12.policy_network)
        state12 = wrapped12.reset(env_keys(B))
        state12, _ = lane12.unroll(state12, params12, next_key(), WARM_STEPS)
        carry12 = lane12.carry_from_state(state12)
        _, noise12, _ = lane12.draw_noise_block(env_keys(B), 1)
        eps12 = torch.randn((env12.action_size, B), generator=g, device=device)
        with torch.no_grad():
            act12, _, _ = lane12.policy_rows(None, nets12.policy_network)(
                lane12._full_obs(carry12["env"], carry12["phase"]), eps12)
        wrap12 = carry12["wrap"].clone()
        wrap12[0, ::3] = L - 1  # every third env reaches the episode limit: the restore
        blocks12 = [carry12["q"], carry12["v"], act12, carry12["env"], noise12[0].contiguous(),
                    carry12["dr"], carry12["first"], wrap12]
        k3_12_err, k3_12_one_err, plain12, wide12 = 0.0, 0.0, [], []
        for n_envs in (B, EVAL_ENVS):
            ins = blocks12 if n_envs == B else [x[:, :n_envs].contiguous() for x in blocks12]
            err, one_err = k3_check("K3[run12]", s12, es12, ins, MAX_DIFFERING_ENVS,
                                    times=plain12 if n_envs == B else None, wider=wide12)
            k3_12_err, k3_12_one_err = max(k3_12_err, err), max(k3_12_one_err, one_err)
        k3_12_plain_ms = plain12[0]

        # K4 at run12's env: T=2 steps from the same states, every third env
        # reaching the episode limit at the second step
        layers12 = fused_unroll.fold_normalizer(None, nets12.policy_network)
        k4_carry12 = dict(carry12, wrap=carry12["wrap"].clone())
        k4_carry12["wrap"][0, ::3] = L - 2
        k4_check12 = k4_blocks(lane12, k4_carry12, B, T_PLAIN)
        k4_12_err, k4_12_one_err, k4_12_plain_ms, want = k4_check(
            f"[run12] at {B} envs x T={T_PLAIN}", s12, es12, layers12, k4_check12,
            MAX_DIFFERING_ENVS)
        aux12 = soa_env.aux_row_map(es12)
        done = want[9][:, aux12["done"][0]] > 0.5
        r0, n = aux12["privileged"]
        first = k4_check12[5][s12.nq + s12.nv + es12.hist :]
        restored = all(torch.equal(want[9][t][r0 : r0 + n][:, done[t]], first[:, done[t]])
                       for t in range(T_PLAIN))
        print(f"  ({int(done.sum())} env-steps ending an episode, their privileged rows "
              f"restored: {restored})", flush=True)
        if not restored or int(done.sum()) == 0:
            raise AssertionError("run12's K4 did not restore the privileged rows on done")

        # team K2 at history 4, the evaluator's shape: 128 nominal envs
        eval12 = wrap_for_training(env12, L)
        estate12 = eval12.reset(env_keys(EVAL_ENVS), caches=True)
        for _ in range(WARM_STEPS):
            estate12 = eval12.step(
                estate12, torch.rand((EVAL_ENVS, env12.action_size), generator=g,
                                     device=device) * 2 - 1)
        k2_blocks12 = [soa_env.rows_block([estate12.qpos]), soa_env.rows_block([estate12.qvel]),
                       soa_env.rows_block([torch.rand((EVAL_ENVS, env12.action_size), generator=g,
                                                      device=device) * 2 - 1]),
                       soa_env.env_block(es12, estate12.info, estate12.obs),
                       soa_env.noise_block(es12, env12.draw_step_noise(env_keys(EVAL_ENVS))),
                       eval12.dr_rows(EVAL_ENVS)]
        got = soa_env.env_step(s12, es12, n_sub, *k2_blocks12)
        torch.cuda.synchronize()
        want, k2_12_plain_ms = timed_once(
            lambda: soa_env.env_step_rows(s12, es12, n_sub, *k2_blocks12))
        per_block, differing, k2_12_err = compare_env_outputs(s12, es12, got, want)
        print(f"team K2[hist4] vs plain at {EVAL_ENVS} envs after {WARM_STEPS} K2 steps "
              f"({int(estate12.info['last_contact'].any(1).sum())} envs with a foot on the "
              f"floor): max abs err per block " + json.dumps(per_block), flush=True)
        for b, what in differing:
            print(f"  env {b} differs: {what}")
        if differing:
            raise AssertionError(f"{len(differing)} of {EVAL_ENVS} envs differ (limit 0)")

        # the new bodies' times, team and one-thread in turns; the plain versions once
        def k3_12():
            soa_env.wrapped_step(s12, es12, n_sub, L, *blocks12)

        def k3_12_one():
            soa_env.wrapped_step_one_thread(s12, es12, n_sub, L, *blocks12)

        k4_in12 = k4_blocks(lane12, k4_carry12, B, T_CHECK)
        k4_in12_long = k4_blocks(lane12, carry12, B, T_UNROLL)

        def k4_12(ins):
            return lambda: fused_unroll.unroll(s12, es12, n_sub, L, activation, layers12, *ins)

        def k4_12_one(ins):
            return lambda: fused_unroll.unroll_one_thread(s12, es12, n_sub, L, activation,
                                                          layers12, *ins)

        k3_12_one_ms = [cuda_ms(k3_12_one, 20)]
        k3_12_ms = [cuda_ms(k3_12, 20), cuda_ms(k3_12, 20)]
        k3_12_one_ms.append(cuda_ms(k3_12_one, 20))
        # K4 per T=4 unroll (the kernels line's unit) and per T=20 unroll
        # beside the default K4's
        k4_12_one_ms = [cuda_ms(k4_12_one(k4_in12), 5)]
        k4_12_ms = [cuda_ms(k4_12(k4_in12), 5), cuda_ms(k4_12(k4_in12), 5)]
        k4_12_one_ms.append(cuda_ms(k4_12_one(k4_in12), 5))
        k4_12_long_one_ms = [cuda_ms(k4_12_one(k4_in12_long), 3)]
        k4_12_long_ms = [cuda_ms(k4_12(k4_in12_long), 3), cuda_ms(k4_12(k4_in12_long), 3)]
        k4_12_long_one_ms.append(cuda_ms(k4_12_one(k4_in12_long), 3))
        k2_12_ms = [cuda_ms(lambda: soa_env.env_step(s12, es12, n_sub, *k2_blocks12), 20)
                    for _ in range(2)]
        print(f"team K3[run12] step at {B} envs: {statistics.median(k3_12_ms):.4f} ms (runs "
              f"{k3_12_ms}); one-thread K3[run12] {statistics.median(k3_12_one_ms):.4f} ms (runs "
              f"{k3_12_one_ms}); A/B {statistics.median(k3_12_one_ms) / statistics.median(k3_12_ms):.3f}x; "
              f"plain {k3_12_plain_ms:.1f} ms", flush=True)
        for T, team_ms, one_ms, plain in (
                (T_CHECK, k4_12_ms, k4_12_one_ms,
                 f"; plain {k4_12_plain_ms:.1f} ms per T={T_PLAIN} unroll"),
                (T_UNROLL, k4_12_long_ms, k4_12_long_one_ms, "")):
            print(f"team K4[run12] per T={T} unroll at {B} envs: "
                  f"{statistics.median(team_ms):.4f} ms (runs {team_ms}), "
                  f"{statistics.median(team_ms) / T:.4f} ms per step; one-thread K4[run12] "
                  f"{statistics.median(one_ms):.4f} ms (runs {one_ms}); A/B "
                  f"{statistics.median(one_ms) / statistics.median(team_ms):.3f}x" + plain,
                  flush=True)
        print(f"team K2[hist4] step at {EVAL_ENVS} envs: {statistics.median(k2_12_ms):.4f} ms "
              f"(runs {k2_12_ms}); plain {k2_12_plain_ms:.1f} ms", flush=True)

    # ---- run12 through the training CLI on the K3 lane ----
    tc12_steps = tc12.batch_size * tc12.unroll_length * tc12.num_minibatches
    n_train12 = math.ceil(TRAIN_TIMESTEPS / tc12_steps)
    unroll12 = n_train12 * (tc12.batch_size * tc12.num_minibatches // B) * tc12.unroll_length
    evals12 = 2 * tc12.episode_length
    cli_runs = {}

    def cli_run(label, config, want, lane_line, run12=True, evals=2, extra=None,
                launcher=False):
        """``python -m puppax_torch.scripts.train --config <config>`` (no
        ``--config`` for None: the defaults), with the ``extra`` overrides,
        for 3 training steps and ``evals`` evaluations (2: before and after the
        training, 1: after it) on the card; its launches against
        ``want`` (team K3, K2, K1, K4; the one-thread kernels none), each
        counted by the body it went through (the model's variant), its lane
        line, the env steps, finite losses and eval metrics; for run12 (the
        curriculum over those steps) the difficulty before each training
        step's rollout on any lane (at least three values) and the critic
        normalizer's count. With ``launcher``, the CLI runs as one rank on
        one card under ``python -m torch.distributed.run --standalone
        --nproc_per_node 1`` (this script's ``launched_cli`` child around the
        CLI's ``main``), the process group over NCCL: its lane line must
        name rank 0 of 1 and the NCCL backend, the metrics JSONL and the
        train state must be written once, and the learner's collectives
        must be the run's (a gradient all-reduce per minibatch update, a
        batch all-gather per training step, the normalizers' moments, the
        advantages' mean and spread per update, the metrics per epoch, an
        all-gather per evaluation). Returns the launches and the launches
        by (library, variant)."""
        tmp = tempfile.mkdtemp(prefix="puppax_torch_cli_")
        over = {"train.num_timesteps": TRAIN_TIMESTEPS, "train.num_evals": evals,
                "train.num_eval_envs": EVAL_ENVS, "train.seed": args.seed,
                "train.checkpoint_path": os.path.join(tmp, "ckpt"),
                "train.metrics_jsonl": os.path.join(tmp, "metrics.jsonl")}
        if run12:
            over["train.curriculum_steps"] = TRAIN_TIMESTEPS
        over.update(extra or {})
        argv = ([] if config is None else ["--config", os.path.join(HERE, config)]) + [
            "--device", str(device)]
        for k, v in over.items():
            argv += ["--set", f"{k}={json.dumps(v)}"]
        if launcher:
            spec, result = os.path.join(tmp, "spec.json"), os.path.join(tmp, "rank0.json")
            # the libraries this process built for run12's model (the one
            # launched run's), loaded by the child under their keys instead
            # of rendering the bodies again (a minute each beside the
            # background builds)
            digest = build._statics_digest(s12, es12)
            preload = [[key[0], key[1], list(key[2]), lib._name]
                       for key, lib in build._LOADED.items() if key[1] == digest]
            with open(spec, "w") as f:
                json.dump({"argv": argv, "B": B, "run12": run12, "out": result,
                           "preload": preload}, f)
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "1", os.path.join(HERE, "chip_smoke.py"),
                   "--launched-cli", spec]
            t0, t_launch = time.perf_counter(), time.time()
            proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"{label}: the launcher exited {proc.returncode}:\n"
                                     + (proc.stdout + proc.stderr)[-6000:])
            text = proc.stdout
            with open(result) as f:
                rec = json.load(f)
            rec["by_body"] = {(name, v): n for name, v, n in rec["by_body"]}
            m = rec["metrics"]
        else:
            out = io.StringIO()
            with cli_spies(B, run12) as rec, contextlib.redirect_stdout(out):
                m = train_cli.main(argv)
            torch.cuda.synchronize()
            text = out.getvalue()
        launches, one_thread = tuple(rec["launches"]), tuple(rec["one_thread"])
        by_body, seen = rec["by_body"], rec["seen"]
        lines = [x for x in text.splitlines() if x.startswith(("config hash", "[puppax"))]
        print("\n".join(lines), flush=True)
        if lane_line not in text:
            raise AssertionError(f"{label}: the lane line is not {lane_line!r}")
        print(f"{label}: team K3 launches {launches[0]} (expected {want[0]}), team K2 launches "
              f"{launches[1]} (expected {want[1]}), team K1 launches {launches[2]} (expected "
              f"{want[2]}), team K4 launches {launches[3]} (expected {want[3]}); one-thread "
              f"launches {one_thread} (expected (0, 0, 0, 0))", flush=True)
        if launches != want or one_thread != (0, 0, 0, 0):
            raise AssertionError(f"{label} did not launch the kernels as expected")
        print(f"{label}: team launches by body " + json.dumps(
            {build.record_name(getattr(build, name.removesuffix("_library").upper()), v): n
             for (name, v), n in by_body.items()}), flush=True)
        tree = checkpoint.restore_checkpoint(os.path.join(tmp, "ckpt", "state"))
        if tree["env_steps"] != TRAIN_TIMESTEPS:
            raise AssertionError(f"{label}: env steps {tree['env_steps']}")
        if run12:
            print(f"{label}: difficulty before each training step's unrolls {seen}", flush=True)
            if len(set(seen)) < 3 or seen != sorted(seen):
                raise AssertionError(f"{label}: the curriculum did not move the difficulty: "
                                     f"{seen}")
            cn = tree["critic_normalizer"]
            print(f"{label}: critic normalizer count {float(cn['count'])} over "
                  f"{cn['mean'].numel()} inputs (obs {env12.observation_size} + privileged "
                  f"{env12.privileged_obs_size}); env steps {tree['env_steps']}", flush=True)
            if float(cn["count"]) != TRAIN_TIMESTEPS:
                raise AssertionError(f"{label}: the critic normalizer's count did not grow as "
                                     f"the run: {float(cn['count'])}")
        losses = {k: v for k, v in m.items() if k.endswith("_loss")}
        if len(losses) != 4 or not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{label}: loss metrics {losses}")
        records = [json.loads(x) for x in open(os.path.join(tmp, "metrics.jsonl"))]
        eval_records = [r for r in records if "eval/episode_reward" in r]
        if ([r["step"] for r in eval_records] != [0, TRAIN_TIMESTEPS][2 - evals:]
                or not all(math.isfinite(v) for r in eval_records for k, v in r.items()
                           if k.startswith("eval/"))):
            raise AssertionError(f"{label}: evaluations {eval_records}")
        print(f"{label}: training/sps {m['training/sps']:.1f}, epoch {m['training/walltime']:.3f} "
              f"s for {n_train12} training steps; per training step: rollout "
              f"{m['training/rollout_ms']:.3f} ms, reorder + normalizer "
              f"{m['training/prepare_ms']:.3f} ms, SGD {m['training/sgd_ms']:.3f} ms (CUDA "
              f"events); one evaluation " + ", ".join(
                  f"at step {r['step']}: {r['eval/epoch_eval_time']:.3f} s wall" for r in eval_records)
              + f"; losses " + json.dumps(losses), flush=True)
        if launcher:
            group, calls = rec["group"], rec["calls"]
            updates = n_train12 * tc12.num_updates_per_batch * tc12.num_minibatches
            norms = 2 * (2 if tc12.privileged_critic else 1)
            want_calls = {"grads": updates, "batch": n_train12, "normalizer": norms * n_train12,
                          "advantages": 2 * updates, "metrics": 1, "eval": evals}
            print(f"{label}: under the launcher, rank {group.get('rank')} of "
                  f"{group.get('world')}, backend {group.get('backend')}, the process group "
                  f"joined in {group.get('init_seconds', float('nan')):.3f} s; the run's "
                  f"collectives {json.dumps(calls)} (expected {json.dumps(want_calls)}); "
                  f"{len(records)} JSONL records; the launcher's wall {wall:.1f} s", flush=True)
            tt = rec["times"]
            print(f"{label}: the launcher's wall split: launcher to the child's start "
                  f"{tt['child'] - t_launch:.1f} s, the child's imports and library loads "
                  f"{tt['cli'] - tt['child']:.1f} s, the CLI's set-up to the first unroll "
                  f"{tt['first_unroll'] - tt['cli']:.1f} s (the group's {group['init_seconds']:.1f} "
                  f"s among them), the first unroll to the CLI's end "
                  f"{tt['end'] - tt['first_unroll']:.1f} s, the child's end to the "
                  f"launcher's {t_launch + wall - tt['end']:.1f} s", flush=True)
            if (group.get("backend"), group.get("rank"), group.get("world")) != ("nccl", 0, 1):
                raise AssertionError(f"{label}: the process group {group}")
            if text.count("rollout fast lane") != 1:
                raise AssertionError(f"{label}: the lane line is printed "
                                     f"{text.count('rollout fast lane')} times")
            if calls != want_calls:
                raise AssertionError(f"{label}: the learner's collectives {calls}, expected "
                                     f"{want_calls}")
        cli_runs[label] = {"tmp": tmp, "metrics": m, "launches": launches, "by_body": by_body,
                           "seen": seen, "records": records,
                           "states": sorted(os.listdir(os.path.join(tmp, "ckpt", "state")))}
        return launches, by_body

    # one evaluation (after the training): the default's run evaluates
    # before the training too
    with Phase("run12 training, K3 lane"):
        (k3_12_launches, k2_12_launches, _, _), _ = cli_run(
            "run12 K3 lane", RUN12_CONFIG, (unroll12, evals12 // 2, 0, 0),
            "rollout fast lane: ON (ok; devices=1, fused-unroll=OFF)", evals=1)
    # the same run as one rank of a one-card NCCL group under the launcher
    with Phase("run12 training, K3 lane, under torch.distributed.run"):
        cli_run("run12 K3 lane, launched", RUN12_CONFIG, (unroll12, evals12 // 2, 0, 0),
                "rollout fast lane: ON (ok; devices=1, rank 0 of 1, backend nccl, "
                "fused-unroll=OFF)", evals=1, launcher=True)
        alone, ranked = cli_runs["run12 K3 lane"], cli_runs["run12 K3 lane, launched"]
        if (ranked["launches"], ranked["by_body"], ranked["seen"]) != (
                alone["launches"], alone["by_body"], alone["seen"]):
            raise AssertionError("the launched run12 run differs from the in-process one in "
                                 "its launches, their bodies or its curriculum")
        # one writer: the JSONL's records and the train states are the
        # in-process run's, kind for kind
        if ([sorted(r) for r in ranked["records"]] != [sorted(r) for r in alone["records"]]
                or ranked["states"] != alone["states"] or alone["states"] != [str(TRAIN_TIMESTEPS)]):
            raise AssertionError(f"the launched run's JSONL or train states are not the "
                                 f"in-process run's: {ranked['records']}, {ranked['states']}")
        print(f"run12 K3 lane, launched: {len(ranked['records'])} JSONL records and train "
              f"states {ranked['states']}, kind for kind the in-process run's", flush=True)
        t_alone, t_ranked = (checkpoint.restore_checkpoint(os.path.join(r["tmp"], "ckpt", "state"))
                             for r in (alone, ranked))
        diffs = [float((a - b).abs().max()) for net in ("policy", "value")
                 for a, b in zip(t_alone["params"][net].values(),
                                 t_ranked["params"][net].values())]
        print(f"run12 K3 lane: training/sps in process {alone['metrics']['training/sps']:.1f}, "
              f"under the launcher {ranked['metrics']['training/sps']:.1f} (launched / in "
              f"process {ranked['metrics']['training/sps'] / alone['metrics']['training/sps']:.3f}); "
              f"SGD {alone['metrics']['training/sgd_ms']:.3f} / "
              f"{ranked['metrics']['training/sgd_ms']:.3f} ms per training step; the final "
              f"weights' largest difference {max(diffs):.3g} (bit for bit: "
              f"{max(diffs) == 0.0})", flush=True)
    # the physics-only and fused lanes with one evaluation (after the
    # training): the K3 lane's run evaluates twice, as the default's
    with Phase("run12 training, physics-only lane"):
        os.environ["PUPPAX_SOA_ENV"] = "off"  # read when the CLI builds the env
        try:
            cli_run("run12 physics-only lane", RUN12_CONFIG,
                    (0, 0, unroll12 + evals12 // 2, 0),
                    "rollout fast lane: OFF (PUPPAX_SOA_ENV=off; devices=1)", evals=1)
        finally:
            del os.environ["PUPPAX_SOA_ENV"]
    with Phase("run12 training, fused-unroll lane"):
        os.environ["PUPPAX_FUSED_UNROLL"] = "on"
        try:
            (_, _, _, k4_12_launches), _ = cli_run(
                "run12 fused-unroll lane", RUN12_CONFIG,
                (0, evals12 // 2, 0, unroll12 // tc12.unroll_length),
                "rollout fast lane: ON (ok; devices=1, fused-unroll=ON)", evals=1)
        finally:
            del os.environ["PUPPAX_FUSED_UNROLL"]

    with Phase("the background builds' end: run9's and run8's bodies"):
        libs = background98.result()
        print(f"{len(libs)} libraries built behind the default's and run12's phases",
              flush=True)
        for kname, label in (*((v, k) for k, v in rec9.items()),
                             *((v, k) for k, v in rec8.items())):
            print_build(kname, label)

    # ---- run9: the heightfield terrain's bodies against plain ----
    with Phase("run9 kernels vs plain"):
        nets9 = networks.make_ppo_networks(
            env9.observation_size, env9.action_size, tc9.policy_hidden_layer_sizes,
            tc9.value_hidden_layer_sizes, tc9.activation, device=device, key=next_key())
        layers9 = fused_unroll.fold_normalizer(None, nets9.policy_network)
        state9 = wrapped9.reset(env_keys(B))
        state9, _ = lane9.unroll(state9, (None, nets9.policy_network), next_key(),
                                 RUN9_WARM_STEPS)
        carry9 = lane9.carry_from_state(state9)
        hs = [i for i, p in enumerate(s9.pairs) if p.kind == "hs"]
        rx, ry = s9.pairs[hs[0]].hf_size[:2]
        # every eighth env past the grid's edge in x (only the floor under it)
        q9 = carry9["q"].clone()
        off = torch.arange(B, device=device) % 8 == 7
        edge = rx + 0.1 + 0.4 * torch.rand(B, generator=g, device=device)
        q9[0] = torch.where(off, torch.where(q9[0] < 0, -edge, edge), q9[0])
        carry9 = dict(carry9, q=q9)
        _, noise9, _ = lane9.draw_noise_block(env_keys(B), 1)
        eps9 = torch.randn((env9.action_size, B), generator=g, device=device)
        r0, n = es9.env_rows["obs_history"]
        with torch.no_grad():
            act9, _, _ = lane9.policy_rows(None, nets9.policy_network)(
                carry9["env"][r0 : r0 + n], eps9)
        blocks9 = [carry9["q"], carry9["v"], act9, carry9["env"], noise9[0].contiguous(),
                   carry9["dr"], carry9["first"], carry9["wrap"]]
        ctrl9 = es9.action_scale * act9 + env9._dev["default_pose"][:, None]
        ctrl9 = torch.minimum(torch.maximum(ctrl9, env9._dev["lowers"][:, None]),
                              env9._dev["uppers"][:, None]).contiguous()
        k1_blocks9 = [carry9["q"], carry9["v"], ctrl9, carry9["dr"]]
        res9 = {}

        def exact9(k, got, one, plain, compare, *args):
            """Team and one-thread kernel against the plain version (``plain``:
            its outputs and milliseconds, ``timed_once``): 0 envs outside
            tolerance and max abs err 0.0 for both."""
            want, plain_ms = plain
            per_block, differing, err = compare(*args, got, want)
            _, one_differing, one_err = compare(*args, one, want)
            res9[k] = dict(err=err, one_err=one_err, plain_ms=plain_ms)
            print(f"team {k}[hfield] vs plain: max abs err per block " + json.dumps(per_block)
                  + f", {len(differing)} envs outside tolerance; one-thread {k}[hfield] vs "
                  f"plain: max abs err {one_err!r}, {len(one_differing)} outside", flush=True)
            if differing or one_differing or err != 0.0 or one_err != 0.0:
                raise AssertionError(f"{k}[hfield] is not bit for bit with its plain version")

        # team K1 at 4096 envs: the contacts on the terrain from its caches
        got = soa.step_batched(s9, *k1_blocks9, n_sub)
        one = soa.step_batched_one_thread(s9, *k1_blocks9, n_sub)
        torch.cuda.synchronize()
        plain = timed_once(lambda: soa.physics_step_rows(s9, n_sub, *k1_blocks9))
        exact9("K1", got, one, plain, compare_physics_outputs, s9)
        d0, _ = s9.cache_rows["con_dist"]
        p0, _ = s9.cache_rows["con_pos"]
        grid = torch.tensor(s9.pairs[hs[0]].hf_grid, dtype=torch.float32, device=device)
        nrow, ncol = grid.shape
        x = got[2][[p0 + 3 * i for i in hs]]
        y = got[2][[p0 + 3 * i + 1 for i in hs]]
        iu = torch.clamp(torch.floor((x + rx) / (2 * rx) * (ncol - 1)), 0, ncol - 2).long()
        iv = torch.clamp(torch.floor((y + ry) / (2 * ry) * (nrow - 1)), 0, nrow - 2).long()
        corners = torch.stack([grid[iv, iu], grid[iv, iu + 1], grid[iv + 1, iu],
                               grid[iv + 1, iu + 1]])
        sloped = (corners != corners[:1]).any(0) & (corners > 0).any(0)
        on_grid = (x.abs() <= rx) & (y.abs() <= ry)
        active = (got[2][[d0 + i for i in hs]] < 0) & on_grid & sloped
        n_hs = int(active.any(0).sum())
        n_off = int(((carry9["q"][0].abs() > rx) | (carry9["q"][1].abs() > ry)).sum())
        print(f"run9 at {B} DR'd envs after {RUN9_WARM_STEPS} kernel steps: {n_hs} envs with an "
              f"active hfield-sphere contact on a nonzero, sloped cell ({int(active.sum())} "
              f"contacts), {n_off} envs off the grid's edge", flush=True)
        if n_hs < MIN_HFIELD_ENVS or n_off == 0:
            raise AssertionError(f"{n_hs} envs touch the terrain's bumps (at least "
                                 f"{MIN_HFIELD_ENVS}), {n_off} sit off the grid")

        # team K2 at the evaluator's 128 envs (the same states' first 128)
        k2_blocks9 = [x_[:, :EVAL_ENVS].contiguous() for x_ in blocks9[:6]]
        got = soa_env.env_step(s9, es9, n_sub, *k2_blocks9)
        one = soa_env.env_step_one_thread(s9, es9, n_sub, *k2_blocks9)
        torch.cuda.synchronize()
        exact9("K2", got, one, timed_once(lambda: soa_env.env_step_rows(s9, es9, n_sub,
                                                                        *k2_blocks9)),
               compare_env_outputs, s9, es9)

        # team K3 at 4096 envs (k3_check holds it bit for bit with the one-thread K3)
        plain9 = []
        err, one_err = k3_check("K3[hfield]", s9, es9, blocks9, 0, RUN9_WARM_STEPS, plain9)
        res9["K3"] = dict(err=err, one_err=one_err, plain_ms=plain9[0])
        if (err, one_err) != (0.0, 0.0):
            raise AssertionError("K3[hfield] is not bit for bit with its plain version")

        # team K4 over T=4 steps from the same states
        err, one_err, k4_9_plain_ms, _ = k4_check(
            f"[hfield] at {B} envs x T={T_PLAIN}", s9, es9, layers9,
            k4_blocks(lane9, carry9, B, T_PLAIN), 0)
        k4_in9 = k4_blocks(lane9, carry9, B, T_CHECK)  # the timed unroll
        res9["K4"] = dict(err=err, one_err=one_err, plain_ms=k4_9_plain_ms)
        if (err, one_err) != (0.0, 0.0):
            raise AssertionError("K4[hfield] is not bit for bit with its plain version")

        # the times, team and one-thread in turns (each plain version's from its check)
        calls9 = {
            "K1": (lambda: soa.step_batched(s9, *k1_blocks9, n_sub),
                   lambda: soa.step_batched_one_thread(s9, *k1_blocks9, n_sub), 20),
            "K2": (lambda: soa_env.env_step(s9, es9, n_sub, *k2_blocks9),
                   lambda: soa_env.env_step_one_thread(s9, es9, n_sub, *k2_blocks9), 20),
            "K3": (lambda: soa_env.wrapped_step(s9, es9, n_sub, L, *blocks9),
                   lambda: soa_env.wrapped_step_one_thread(s9, es9, n_sub, L, *blocks9), 20),
            "K4": (lambda: fused_unroll.unroll(s9, es9, n_sub, L, activation, layers9, *k4_in9),
                   lambda: fused_unroll.unroll_one_thread(s9, es9, n_sub, L, activation,
                                                          layers9, *k4_in9), 5),
        }
        for k, (team_fn, one_fn, reps) in calls9.items():
            one_ms = [cuda_ms(one_fn, reps)]
            team_ms = [cuda_ms(team_fn, reps), cuda_ms(team_fn, reps)]
            one_ms.append(cuda_ms(one_fn, reps))
            res9[k].update(ms=team_ms, one_ms=one_ms)
            what = f"per T={T_CHECK} unroll at {B} envs" if k == "K4" else \
                f"step at {EVAL_ENVS if k == 'K2' else B} envs"
            print(f"team {k}[hfield] {what}: {statistics.median(team_ms):.4f} ms (runs "
                  f"{team_ms}); one-thread {k}[hfield] {statistics.median(one_ms):.4f} ms (runs "
                  f"{one_ms}); A/B {statistics.median(one_ms) / statistics.median(team_ms):.3f}x; "
                  f"plain {res9[k]['plain_ms']:.1f} ms ({smi})", flush=True)

    # ---- run9 through the training CLI on the K3 lane ----
    with Phase("run9 training, K3 lane"):
        if (tc9.batch_size, tc9.unroll_length, tc9.num_minibatches) != (
                tc12.batch_size, tc12.unroll_length, tc12.num_minibatches):
            raise AssertionError("run9's training steps differ from run12's")
        (k3_9_launches, k2_9_launches, _, _), by_body = cli_run(
            "run9 K3 lane", RUN9_CONFIG, (unroll12, evals12 // 2, 0, 0),
            "rollout fast lane: ON (ok; devices=1, fused-unroll=OFF)", run12=False, evals=1)
        if (by_body.get(("wrapped_step_team_library", "hfield")) != k3_9_launches
                or by_body.get(("env_step_team_library", "hfield")) != k2_9_launches):
            raise AssertionError(f"run9's launches did not all go through the [hfield] "
                                 f"bodies: {by_body}")

    # ---- run8: the obstacle terrain's bodies against plain ----
    with Phase("run8 kernels vs plain"):
        nets8 = networks.make_ppo_networks(
            env8.observation_size, env8.action_size, tc8.policy_hidden_layer_sizes,
            tc8.value_hidden_layer_sizes, tc8.activation, device=device, key=next_key())
        state8 = wrapped8.reset(env_keys(B))
        state8, _ = lane8.unroll(state8, (None, nets8.policy_network), next_key(),
                                 RUN8_WARM_STEPS)
        carry8 = lane8.carry_from_state(state8)
        # the resets spread over 4 x 4 m and the boxes over 10 x 10 m: every
        # second env's base is moved onto a box, where that puts a sphere in it
        model8 = pipeline.model_tensors(env8.model, torch.float32, device)
        _, natural8 = place_over_boxes(s8, model8, carry8["q"],
                                       torch.zeros(B, dtype=torch.bool, device=device), g, 0)
        q8, placed8 = place_over_boxes(s8, model8, carry8["q"],
                                       torch.arange(B, device=device) % 2 == 0, g)
        carry8 = dict(carry8, q=q8)
        _, noise8, _ = lane8.draw_noise_block(env_keys(B), 1)
        eps8 = torch.randn((env8.action_size, B), generator=g, device=device)
        r0, n = es8.env_rows["obs_history"]
        with torch.no_grad():
            act8, _, _ = lane8.policy_rows(None, nets8.policy_network)(
                carry8["env"][r0 : r0 + n], eps8)
        blocks8 = [carry8["q"], carry8["v"], act8, carry8["env"], noise8[0].contiguous(),
                   carry8["dr"], carry8["first"], carry8["wrap"]]
        # the envs with an active sphere-box row in the step's last forward
        # pass: a box pair's distance below 0 in team K2's contact caches
        d0, _ = s8.cache_rows["con_dist"]
        nbs = s8.boxes.n * len(s8.boxes.spheres)
        caches8 = soa_env.env_step(s8, es8, n_sub, *blocks8[:6])[2]
        active8 = caches8[d0 + s8.boxes.first : d0 + s8.boxes.first + nbs] < 0
        n_box = int(active8.any(0).sum())
        print(f"run8 at {B} DR'd envs after {RUN8_WARM_STEPS} kernel steps: "
              f"{int(natural8.sum())} envs with a sphere in a box as they stand, "
              f"{int(placed8.sum())} after moving every second base onto a box; {n_box} envs "
              f"with an active sphere-box row after the step ({int(active8.sum())} rows of "
              f"{nbs} pairs)", flush=True)
        if n_box < MIN_BOX_ENVS:
            raise AssertionError(f"{n_box} envs have an active sphere-box row (at least "
                                 f"{MIN_BOX_ENVS})")
        # the plain versions, each timed once where it is checked (the
        # loops over the boxes are a torch op each: seconds per call)
        res8 = {"K3": dict(err=0.0, one_err=0.0)}
        plain8, wide8 = [], []
        for n_envs in (B, EVAL_ENVS):
            ins = blocks8 if n_envs == B else [x_[:, :n_envs].contiguous() for x_ in blocks8]
            err, one_err = k3_check("K3[boxes]", s8, es8, ins, MAX_DIFFERING_ENVS,
                                    RUN8_WARM_STEPS, plain8, wider=wide8)
            res8["K3"] = dict(err=max(err, res8["K3"]["err"]),
                              one_err=max(one_err, res8["K3"]["one_err"]))
        # team K2 at the evaluator's 128 envs (the same states' first 128)
        k2_blocks8 = [x_[:, :EVAL_ENVS].contiguous() for x_ in blocks8[:6]]
        got = soa_env.env_step(s8, es8, n_sub, *k2_blocks8)
        torch.cuda.synchronize()
        want, k2_8_plain_ms = timed_once(
            lambda: soa_env.env_step_rows(s8, es8, n_sub, *k2_blocks8))
        per_block, differing, err = compare_env_outputs(s8, es8, got, want)
        res8["K2"] = dict(err=err, plain_ms=k2_8_plain_ms)
        print(f"team K2[boxes] vs plain at {EVAL_ENVS} envs: max abs err per block "
              + json.dumps(per_block) + f", {len(differing)} envs outside tolerance",
              flush=True)
        for b_, what in differing:
            print(f"  env {b_} differs: {what}")
        if len(differing) > MAX_DIFFERING_ENVS:
            raise AssertionError(f"{len(differing)} of {EVAL_ENVS} envs differ (team K2[boxes])")
        # team K1[boxes] (the physics-only lane's) under the policy's motor
        # targets at 4096 envs, and at the evaluator's 128 against the first
        # 128 envs of the same plain run (each env's rows are its own)
        ctrl8 = es8.action_scale * act8 + env8._dev["default_pose"][:, None]
        ctrl8 = torch.minimum(torch.maximum(ctrl8, env8._dev["lowers"][:, None]),
                              env8._dev["uppers"][:, None]).contiguous()
        k1_blocks8 = [carry8["q"], carry8["v"], ctrl8, carry8["dr"]]
        k1_small8 = [x_[:, :EVAL_ENVS].contiguous() for x_ in k1_blocks8]
        got = soa.step_batched(s8, *k1_blocks8, n_sub)
        got_small = soa.step_batched(s8, *k1_small8, n_sub)
        torch.cuda.synchronize()
        want, k1_8_plain_ms = timed_once(lambda: soa.physics_step_rows(s8, n_sub, *k1_blocks8))
        want_small = [w_[:, :EVAL_ENVS] for w_ in want]
        active_k1 = got[2][d0 + s8.boxes.first : d0 + s8.boxes.first + nbs] < 0
        res8["K1"] = dict(plain_ms=k1_8_plain_ms, err=0.0)
        for n_envs, g_, w_ in ((B, got, want), (EVAL_ENVS, got_small, want_small)):
            per_block, differing, err = compare_physics_outputs(s8, g_, w_)
            _, bits = probes.compare_exact(g_, w_)
            res8["K1"]["err"] = max(res8["K1"]["err"], err)
            print(f"team K1[boxes] vs plain at {n_envs} envs: max abs err per block "
                  + json.dumps(per_block) + f", {len(differing)} envs outside tolerance, "
                  f"{bits} not bit for bit", flush=True)
            for b_, what in differing:
                print(f"  env {b_} differs: {what}")
            if len(differing) > MAX_DIFFERING_ENVS:
                raise AssertionError(f"{len(differing)} of {n_envs} envs differ "
                                     f"(team K1[boxes])")
        n_box_k1 = int(active_k1.any(0).sum())
        print(f"team K1[boxes]'s caches: {n_box_k1} of {B} envs with an active sphere-box row "
              f"({int(active_k1.sum())} rows)", flush=True)
        if n_box_k1 < MIN_BOX_ENVS:
            raise AssertionError(f"{n_box_k1} envs have an active sphere-box row in K1's "
                                 f"caches (at least {MIN_BOX_ENVS})")
        # team K4[boxes] (the fused lane's) over T=1 step from the same
        # states: its plain version takes ~20 s a step (the box scratch's
        # reuse across steps is held by the CPU tests' g++ builds at T=2)
        layers8 = fused_unroll.fold_normalizer(None, nets8.policy_network)
        k4_in8 = k4_blocks(lane8, carry8, B, RUN8_K4_PLAIN_T)
        got = fused_unroll.unroll(s8, es8, n_sub, L, activation, layers8, *k4_in8)
        torch.cuda.synchronize()
        want, k4_8_plain_ms = timed_once(lambda: fused_unroll.unroll_rows(
            s8, es8, n_sub, L, activation, layers8, *k4_in8))
        per_block, differing, err = compare_unroll(s8, es8, soa_env.aux_row_map(es8), got, want)
        _, bits = probes.compare_exact([x_.reshape(-1, B) for x_ in got if x_ is not None],
                                       [x_.reshape(-1, B) for x_ in want if x_ is not None])
        res8["K4"] = dict(err=err, plain_ms=k4_8_plain_ms)
        print(f"team K4[boxes] vs plain at {B} envs x T={RUN8_K4_PLAIN_T}: max abs err per "
              f"block " + json.dumps(per_block) + f", {len(differing)} envs outside tolerance, "
              f"{bits} not bit for bit; the plain version {k4_8_plain_ms:.1f} ms for the "
              f"{RUN8_K4_PLAIN_T} step(s)", flush=True)
        for b_, what in differing:
            print(f"  env {b_} differs: {what}")
        if len(differing) > MAX_DIFFERING_ENVS:
            raise AssertionError(f"{len(differing)} of {B} envs differ (team K4[boxes])")
        # the times, team and one-thread K3 in turns (the plain versions' above)
        k3_8 = (lambda: soa_env.wrapped_step(s8, es8, n_sub, L, *blocks8),
                lambda: soa_env.wrapped_step_one_thread(s8, es8, n_sub, L, *blocks8))
        one_ms = [cuda_ms(k3_8[1], 10)]
        team_ms = [cuda_ms(k3_8[0], 10), cuda_ms(k3_8[0], 10)]
        one_ms.append(cuda_ms(k3_8[1], 10))
        res8["K3"].update(ms=team_ms, one_ms=one_ms, plain_ms=plain8[0])
        res8["K2"]["ms"] = [cuda_ms(lambda: soa_env.env_step(s8, es8, n_sub, *k2_blocks8), 20)
                            for _ in range(2)]
        res8["K1"]["ms"] = [cuda_ms(lambda: soa.step_batched(s8, *k1_blocks8, n_sub), 10)
                            for _ in range(2)]
        res8["K1"]["ms_small"] = [cuda_ms(lambda: soa.step_batched(s8, *k1_small8, n_sub), 20)
                                  for _ in range(2)]
        k4_t8 = k4_blocks(lane8, carry8, B, T_CHECK)  # every K4 entry's unit: a T=4 unroll
        res8["K4"]["ms"] = [cuda_ms(lambda: fused_unroll.unroll(s8, es8, n_sub, L, activation,
                                                                layers8, *k4_t8), 3)
                            for _ in range(2)]
        print(f"team K3[boxes] step at {B} envs: {statistics.median(team_ms):.4f} ms (runs "
              f"{team_ms}); one-thread K3[boxes] {statistics.median(one_ms):.4f} ms (runs "
              f"{one_ms}); A/B {statistics.median(one_ms) / statistics.median(team_ms):.3f}x; "
              f"plain {res8['K3']['plain_ms']:.1f} ms; team K2[boxes] step at {EVAL_ENVS} "
              f"envs: {statistics.median(res8['K2']['ms']):.4f} ms (runs {res8['K2']['ms']}), "
              f"plain {res8['K2']['plain_ms']:.1f} ms ({smi})", flush=True)
        print(f"team K1[boxes] step at {B} envs: {statistics.median(res8['K1']['ms']):.4f} ms "
              f"(runs {res8['K1']['ms']}), plain {res8['K1']['plain_ms']:.1f} ms; at "
              f"{EVAL_ENVS} envs {statistics.median(res8['K1']['ms_small']):.4f} ms (runs "
              f"{res8['K1']['ms_small']}); team K4[boxes] per T={T_CHECK} unroll at {B} envs: "
              f"{statistics.median(res8['K4']['ms']):.4f} ms (runs {res8['K4']['ms']}), plain "
              f"{res8['K4']['plain_ms']:.1f} ms per T={RUN8_K4_PLAIN_T} unroll ({smi})",
              flush=True)

    # ---- run8 through the training CLI on the default (K3) lane ----
    with Phase("run8 training, K3 lane"):
        if (tc8.batch_size, tc8.unroll_length, tc8.num_minibatches) != (
                tc12.batch_size, tc12.unroll_length, tc12.num_minibatches):
            raise AssertionError("run8's training steps differ from run12's")
        (k3_8_launches, k2_8_launches, _, _), by_body = cli_run(
            "run8 K3 lane", RUN8_CONFIG, (unroll12, evals12 // 2, 0, 0),
            "rollout fast lane: ON (ok; devices=1, fused-unroll=OFF)", run12=False, evals=1)
        if (by_body.get(("wrapped_step_team_library", "boxes")) != k3_8_launches
                or by_body.get(("env_step_team_library", "boxes")) != k2_8_launches):
            raise AssertionError(f"run8's launches did not all go through the [boxes] "
                                 f"bodies: {by_body}")

    # ---- run8 through the training CLI on the physics-only and fused lanes ----
    with Phase("run8 training, physics-only lane"):
        os.environ["PUPPAX_SOA_ENV"] = "off"  # read when the CLI builds the env
        try:
            (_, _, k1_8_launches, _), by_body = cli_run(
                "run8 physics-only lane", RUN8_CONFIG, (0, 0, unroll12 + evals12 // 2, 0),
                "rollout fast lane: OFF (PUPPAX_SOA_ENV=off; devices=1)", run12=False, evals=1)
        finally:
            del os.environ["PUPPAX_SOA_ENV"]
        if by_body != {("physics_step_team_library", "boxes"): k1_8_launches}:
            raise AssertionError(f"run8's physics-only launches did not all go through team "
                                 f"K1[boxes]: {by_body}")
    with Phase("run8 training, fused-unroll lane"):
        os.environ["PUPPAX_FUSED_UNROLL"] = "on"
        try:
            (_, k2_8f_launches, _, k4_8_launches), by_body = cli_run(
                "run8 fused-unroll lane", RUN8_CONFIG,
                (0, evals12 // 2, 0, unroll12 // tc8.unroll_length),
                "rollout fast lane: ON (ok; devices=1, fused-unroll=ON)", run12=False, evals=1)
        finally:
            del os.environ["PUPPAX_FUSED_UNROLL"]
        if by_body != {("fused_unroll_team_library", "boxes"): k4_8_launches,
                       ("env_step_team_library", "boxes"): k2_8f_launches}:
            raise AssertionError(f"run8's fused-unroll launches did not all go through team "
                                 f"K4[boxes] and team K2[boxes]: {by_body}")

    # ---- the capsule-legged Pupper (env.path): its team bodies against plain ----
    with Phase("the background builds' end: the capsule model's bodies"):
        libs = background_c.result()
        print(f"{len(libs)} libraries built behind run9's and run8's phases", flush=True)
        for kname, label in ((v, f"team {k}[capsule]") for k, v in recc.items()):
            print_build(kname, label)
    with Phase("capsule kernels vs plain"):
        nets_c = networks.make_ppo_networks(
            env_c.observation_size, env_c.action_size, tc.policy_hidden_layer_sizes,
            tc.value_hidden_layer_sizes, tc.activation, device=device, key=next_key())
        state_c = wrapped_c.reset(env_keys(B))
        state_c, _ = lane_c.unroll(state_c, (None, nets_c.policy_network), next_key(),
                                   CAPSULE_WARM_STEPS)
        carry_c = lane_c.carry_from_state(state_c)
        _, noise_c, _ = lane_c.draw_noise_block(env_keys(B), 1)
        eps_c = torch.randn((env_c.action_size, B), generator=g, device=device)
        r0, n = esc.env_rows["obs_history"]
        with torch.no_grad():
            act_c, _, _ = lane_c.policy_rows(None, nets_c.policy_network)(
                carry_c["env"][r0 : r0 + n], eps_c)
        blocks_c = [carry_c["q"], carry_c["v"], act_c, carry_c["env"], noise_c[0].contiguous(),
                    carry_c["dr"], carry_c["first"], carry_c["wrap"]]
        res_c = {}

        def held(k, n_envs, got_, want_, compare, limit, *args):
            """A team body against its plain version (``compare``), at most
            ``limit`` envs outside tolerance; records the largest error."""
            per_block, differing, err = compare(*args, got_, want_)
            _, bits = probes.compare_exact(
                [x_.reshape(-1, n_envs) for x_ in got_ if x_ is not None],
                [x_.reshape(-1, n_envs) for x_ in want_ if x_ is not None])
            res_c.setdefault(k, {"err": 0.0})
            res_c[k]["err"] = max(res_c[k]["err"], err)
            print(f"team {k}[capsule] vs plain at {n_envs} envs: max abs err per block "
                  + json.dumps(per_block) + f", {len(differing)} envs outside tolerance, "
                  f"{bits} not bit for bit", flush=True)
            for b_, what in differing:
                print(f"  env {b_} differs: {what}")
            if len(differing) > limit:
                raise AssertionError(f"{len(differing)} of {n_envs} envs differ (team "
                                     f"{k}[capsule], limit {limit})")

        # team K3 at 4096 envs
        got = soa_env.wrapped_step(sc, esc, n_sub, L, *blocks_c)
        torch.cuda.synchronize()
        want, plain_ms = timed_once(lambda: soa_env.wrapped_step_rows(sc, esc, n_sub, L,
                                                                      *blocks_c))
        held("K3", B, got, want, compare_outputs, MAX_DIFFERING_ENVS, sc, esc,
             soa_env.aux_row_map(esc))
        res_c["K3"]["plain_ms"] = plain_ms
        # team K2 at the evaluator's 128 envs (the same states' first 128)
        k2_blocks_c = [x_[:, :EVAL_ENVS].contiguous() for x_ in blocks_c[:6]]
        got = soa_env.env_step(sc, esc, n_sub, *k2_blocks_c)
        torch.cuda.synchronize()
        want, plain_ms = timed_once(lambda: soa_env.env_step_rows(sc, esc, n_sub,
                                                                  *k2_blocks_c))
        held("K2", EVAL_ENVS, got, want, compare_env_outputs, 0, sc, esc)
        res_c["K2"]["plain_ms"] = plain_ms
        # team K1 (the physics-only lane's) under the policy's motor targets
        # at 4096 envs, and at 128 against that run's first 128 envs
        ctrl_c = esc.action_scale * act_c + env_c._dev["default_pose"][:, None]
        ctrl_c = torch.minimum(torch.maximum(ctrl_c, env_c._dev["lowers"][:, None]),
                               env_c._dev["uppers"][:, None]).contiguous()
        k1_blocks_c = [carry_c["q"], carry_c["v"], ctrl_c, carry_c["dr"]]
        k1_small_c = [x_[:, :EVAL_ENVS].contiguous() for x_ in k1_blocks_c]
        got_k1c = soa.step_batched(sc, *k1_blocks_c, n_sub)
        got_small = soa.step_batched(sc, *k1_small_c, n_sub)
        torch.cuda.synchronize()
        want_k1c, plain_ms = timed_once(lambda: soa.physics_step_rows(sc, n_sub, *k1_blocks_c))
        held("K1", B, got_k1c, want_k1c, compare_physics_outputs, MAX_DIFFERING_ENVS, sc)
        held("K1", EVAL_ENVS, got_small, [w_[:, :EVAL_ENVS] for w_ in want_k1c],
             compare_physics_outputs, MAX_DIFFERING_ENVS, sc)
        res_c["K1"]["plain_ms"] = plain_ms
        # the envs with an active row of each kind in team K1's caches
        d0, npair_c = sc.cache_rows["con_dist"]
        kinds_c = [p.kind for p in sc.pairs]
        pen_c = got_k1c[2][d0 : d0 + npair_c] < 0
        active_c = {k: pen_c[[i for i, kk in enumerate(kinds_c) if kk == k]]
                    for k in ("ps", "ss", "pc", "sc", "cc")}
        print(f"capsule model at {B} DR'd envs after {CAPSULE_WARM_STEPS} kernel steps, team "
              f"K1's caches: envs with an active row of each kind " + json.dumps(
                  {k: int(a.any(0).sum()) for k, a in active_c.items()}) + ", rows " + json.dumps(
                  {k: int(a.sum()) for k, a in active_c.items()}), flush=True)
        if int(active_c["pc"].any(0).sum()) == 0:
            raise AssertionError("no env has an active plane-capsule row: the capsule feet "
                                 "went unchecked")
        # team K4 over T=4 steps from the same states
        layers_c = fused_unroll.fold_normalizer(None, nets_c.policy_network)
        k4_in_c = k4_blocks(lane_c, carry_c, B, T_CHECK)
        got = fused_unroll.unroll(sc, esc, n_sub, L, activation, layers_c, *k4_in_c)
        torch.cuda.synchronize()
        want, plain_ms = timed_once(lambda: fused_unroll.unroll_rows(
            sc, esc, n_sub, L, activation, layers_c, *k4_in_c))
        held("K4", B, got, want, compare_unroll, MAX_DIFFERING_ENVS, sc, esc,
             soa_env.aux_row_map(esc))
        res_c["K4"].update(plain_ms=plain_ms, plain_unroll_T=T_CHECK)

        # team K1[capsule] against the torch pipeline (the MJX caps: a
        # standing robot has 8 plane-capsule rows against max_geom_pairs 4,
        # so the envs outside the caps part by design; phase 6's rule). The
        # pipeline runs one substep at a time, so an env counts as outside
        # the caps when any substep's forward pass (or the kernel's last)
        # has more penetrating rows than they keep
        kinds_t = torch.tensor([("ps", "ss", "pc", "sc", "cc").index(k) for k in kinds_c],
                               device=device)
        m_c = env_c.model

        def beyond_caps(pen):
            per_kind = torch.stack([pen[:, kinds_t == k].sum(1) for k in range(5)], 1)
            return (per_kind.amax(1) > m_c.max_geom_pairs) | (
                per_kind.sum(1) > m_c.max_contact_points)

        ps_c = pipeline._zeros_state(wrapped_c.model, carry_c["q"].t(), carry_c["v"].t())
        outside = beyond_caps(pen_c.t())
        for _ in range(n_sub):
            ps_c = pipeline.pipeline_step(wrapped_c.model, ps_c, ctrl_c.t(), 1)
            outside |= beyond_caps(ps_c.contact_dist < 0)
        ref_c = state_blocks(sc, ps_c)
        torch.cuda.synchronize()
        tols_c = physics_tols(sc, ref_c)
        _, differing, pipe_err = _differing(("q", "v"), got_k1c[:2], ref_c[:2], tols_c)
        n_out = int(outside.sum())
        n_out_diff = n_outside_differing(differing, outside)
        in_cap = [b_ for b_, _ in differing if not bool(outside[b_])]
        explained = []
        if in_cap:  # do they agree once the emission's line search converges?
            idx = torch.tensor(in_cap, device=device)
            trips = (soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS)
            soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS = CONVERGED_LS_TRIPS
            try:
                conv = soa.physics_step_rows(sc, n_sub, *[x_[:, idx].contiguous()
                                                          for x_ in k1_blocks_c])
            finally:
                soa.LS_EXPAND_ITERS, soa.LS_ILLINOIS_ITERS = trips
            _, still, _ = _differing(("q", "v"), conv[:2], [x_[:, idx] for x_ in ref_c[:2]],
                                     {k: t[:, idx] for k, t in tols_c.items()})
            still_envs = {in_cap[i] for i, _ in still}
            explained = [b_ for b_ in in_cap if b_ not in still_envs]
        unexplained = len(differing) - n_out_diff - len(explained)
        print(f"team K1[capsule] vs torch pipeline_step at {B} envs: {len(differing)} envs "
              f"outside qpos 5e-5 / scaled qvel 5e-4 (max abs err {pipe_err!r}); of them "
              f"{n_out_diff} outside the MJX caps, {len(explained)} in the caps that agree "
              f"once the line search runs {CONVERGED_LS_TRIPS} trips, {unexplained} else; "
              f"{n_out} envs outside the caps in all", flush=True)
        for b_, what in differing[:8]:
            print(f"  env {b_} differs (outside the caps: {bool(outside[b_])}, line search: "
                  f"{b_ in explained}): {what}")
        if unexplained > n_out:
            raise AssertionError(f"{unexplained} envs differ from the torch pipeline beyond "
                                 f"the caps and the line search (limit {n_out})")

        # the times (each plain version's from its check)
        res_c["K3"]["ms"] = [cuda_ms(lambda: soa_env.wrapped_step(sc, esc, n_sub, L,
                                                                  *blocks_c), 20)
                             for _ in range(2)]
        res_c["K2"]["ms"] = [cuda_ms(lambda: soa_env.env_step(sc, esc, n_sub, *k2_blocks_c),
                                     20) for _ in range(2)]
        res_c["K1"]["ms"] = [cuda_ms(lambda: soa.step_batched(sc, *k1_blocks_c, n_sub), 20)
                             for _ in range(2)]
        res_c["K1"]["ms_small"] = [cuda_ms(lambda: soa.step_batched(sc, *k1_small_c, n_sub),
                                           20) for _ in range(2)]
        res_c["K4"]["ms"] = [cuda_ms(lambda: fused_unroll.unroll(sc, esc, n_sub, L, activation,
                                                                 layers_c, *k4_in_c), 5)
                             for _ in range(2)]
        for k, what in (("K3", f"step at {B} envs"), ("K2", f"step at {EVAL_ENVS} envs"),
                        ("K1", f"step at {B} envs"), ("K4", f"per T={T_CHECK} unroll at {B} "
                                                            f"envs")):
            print(f"team {k}[capsule] {what}: {statistics.median(res_c[k]['ms']):.4f} ms (runs "
                  f"{res_c[k]['ms']}); plain {res_c[k]['plain_ms']:.1f} ms ({smi})", flush=True)
        print(f"team K1[capsule] step at {EVAL_ENVS} envs: "
              f"{statistics.median(res_c['K1']['ms_small']):.4f} ms (runs "
              f"{res_c['K1']['ms_small']})", flush=True)

    # ---- the capsule model through the training CLI (--set env.path=...) on
    # all three lanes: the default TrainConfig, 3 training steps, 1 evaluation ----
    steps_c = tc.batch_size * tc.unroll_length * tc.num_minibatches
    if math.ceil(TRAIN_TIMESTEPS / steps_c) != n_train12:
        raise AssertionError("the default config's training steps differ from run12's")
    caps_over = {"env.path": caps_path}
    with Phase("capsule training, K3 lane"):
        (k3_c_launches, k2_c_launches, _, _), by_body = cli_run(
            "capsule K3 lane", None, (unroll_steps, evals // 2, 0, 0),
            "rollout fast lane: ON (ok; devices=1, fused-unroll=OFF)", run12=False, evals=1,
            extra=caps_over)
        if by_body != {("wrapped_step_team_library", cv): k3_c_launches,
                       ("env_step_team_library", cv): k2_c_launches}:
            raise AssertionError(f"the capsule model's launches did not all go through team "
                                 f"K3[capsule] and team K2[capsule]: {by_body}")
    with Phase("capsule training, physics-only lane"):
        os.environ["PUPPAX_SOA_ENV"] = "off"  # read when the CLI builds the env
        try:
            (_, _, k1_c_launches, _), by_body = cli_run(
                "capsule physics-only lane", None, (0, 0, unroll_steps + evals // 2, 0),
                "rollout fast lane: OFF (PUPPAX_SOA_ENV=off; devices=1)", run12=False, evals=1,
                extra=caps_over)
        finally:
            del os.environ["PUPPAX_SOA_ENV"]
        if by_body != {("physics_step_team_library", cv): k1_c_launches}:
            raise AssertionError(f"the capsule model's physics-only launches did not all go "
                                 f"through team K1[capsule]: {by_body}")
    with Phase("capsule training, fused-unroll lane"):
        os.environ["PUPPAX_FUSED_UNROLL"] = "on"
        try:
            (_, k2_cf_launches, _, k4_c_launches), by_body = cli_run(
                "capsule fused-unroll lane", None,
                (0, evals // 2, 0, unroll_steps // tc.unroll_length),
                "rollout fast lane: ON (ok; devices=1, fused-unroll=ON)", run12=False, evals=1,
                extra=caps_over)
        finally:
            del os.environ["PUPPAX_FUSED_UNROLL"]
        if by_body != {("fused_unroll_team_library", cv): k4_c_launches,
                       ("env_step_team_library", cv): k2_cf_launches}:
            raise AssertionError(f"the capsule model's fused-unroll launches did not all go "
                                 f"through team K4[capsule] and team K2[capsule]: {by_body}")

    # ---- the kernel-time probes, on the K1 check's 4096 DR'd states ----
    with Phase("probes: build records"):
        libs = background_probes.result()
        build.nice = 0
        print(f"{len(libs)} probe libraries built behind run8's and the capsule model's "
              f"phases", flush=True)
        fmad_flags = build.probe_flags(True)
        probe_records = {
            **{probes.k1_probe_name(cut): build.record_name(build.PROBE_PHYSICS, cut or "full")
               for cut in soa.PHASES},
            **{probes.k1_probe_name(cut, team=True): build.record_name(build.PROBE_PHYSICS_TEAM,
                                                                       cut or "full")
               for cut in soa.PHASES},
            probes.k1_probe_name(None, fmad=True): build.record_name(build.PROBE_PHYSICS, "full",
                                                                     fmad_flags),
            probes.k1_probe_name(None, fmad=True, team=True): build.record_name(
                build.PROBE_PHYSICS_TEAM, "full", fmad_flags),
            **{probe_fma_fusion.chain_name(fmad, one_element): build.record_name(
                build.FMA_CHAIN if one_element else build.FMA_CHAIN_ILP, "",
                build.probe_flags(fmad))
               for one_element in (False, True) for fmad in (False, True)},
            "add_one": build.record_name(build.ADD_ONE_PDL),
            probe_launch_overhead.ONE_ELEMENT: build.record_name(build.ADD_ONE),
            **{name: build.record_name(build.PROBE_COPY) for name in copy_names},
            soa_probe.soa_name(): soa_probe.record(),
            soa_probe.soa_name(team=True): soa_probe.record(team=True),
            "spd_solve": build.record_name(build.PROBE_SPD_WARP),
            "spd_solve[one-thread]": build.record_name(build.PROBE_SPD),
            profile_overhead.FK: build.record_name(build.PROBE_PHYSICS, "fk"),
            profile_overhead.FK_TEAM: profile_overhead.fk_team_record(),
        }
        probes.print_builds(list(dict.fromkeys(probe_records.values())))

    with Phase("probes"):
        probes.launches.clear()
        cuts = profile_kernel_phases.run(s1, n_sub, k1_blocks)
        layouts = profile_layout.run(s1, n_sub, k1_blocks)
        team_layouts = profile_layout.run_team(s1, n_sub, k1_blocks)
        chain = probe_fma_fusion.run_chain(device)
        if not chain[("tpu", "muladd", True, "redesign")]["exact"]:
            raise AssertionError("the --fmad=true chain was not held bit for bit: the SASS does "
                                 "not show every pair as one FFMA in both designs")
        k1_fmad = probe_fma_fusion.run_k1(s1, n_sub, k1_blocks, max_outside=MAX_DIFFERING_ENVS)
        overhead = probe_launch_overhead.run(s1, n_sub, k1_blocks, production={
            "team K3: soa_env.wrapped_step (4096 envs)": k3_step,
            "K1: soa.step_batched (4096 envs)": lambda: soa.step_batched(s1, *k1_blocks, n_sub),
        })
        # every copy at 4096 and at one block of 128 envs, bit for bit, the
        # element-parallel copy and the one-thread copy (check_copy raises
        # unless both are); their times: profile_overhead and profile_scan
        copy_ins = {"q": k1_blocks[:1], "min": k1_blocks[:2], "full": k1_blocks}
        for mode, ins in copy_ins.items():
            for n_envs in (B, EVAL_ENVS):
                err, differing, _ = probes.check_copy(
                    mode, [x[:, :n_envs].contiguous() for x in ins], s1.ncache)
                print(f"{probes.copy_name(mode, n_envs)} vs plain at {n_envs} envs: max abs err "
                      f"{err!r}, {differing} envs differ (the one-thread copy: 0 too)",
                      flush=True)
        copies = profile_overhead.run(s1, n_sub, k1_blocks, fk_check_envs=(EVAL_ENVS,))
        scan_state = wrapped.reset(env_keys(B))
        scan = profile_scan.run(k1_blocks[0], (lane, scan_state, params,
                                               *profile_scan.lane_draws(lane, scan_state, next_key())))
        profile_boundary.run(env_po, k1_blocks)
        probe_degradation.run()
        # probe group C on their own inputs (the TPU probes' recipes), at 4096 and 128 envs
        with Phase("probes: group C"):
            soa_res = soa_probe.run(device, (soa_probe.ROUNDS,), B, args.seed, (B, EVAL_ENVS),
                                    team_warps=[soa_probe.TEAM_WARPS])
            spd_res = spd_probe.run(device, B, 0, (B, EVAL_ENVS, EVAL_ENVS + 2), (B, EVAL_ENVS))
            # team P12's time per heaviest-stream operation beside production team K1's
            soa_t = soa_res[soa_probe.ROUNDS]["team"][soa_probe.TEAM_WARPS]
            k1_heaviest = max(build.last_build["physics_step_team"]["stream_ops"])
            print(f"team P12 ({soa_probe.TEAM_WARPS} warps): heaviest stream {soa_t['heaviest']}, "
                  f"{soa_t['barriers']} barriers, {soa_t['ns_per_heaviest_op']:.3f} ns per "
                  f"heaviest-stream op; team K1: heaviest stream {k1_heaviest}, "
                  f"{statistics.median(k1_ms) * 1e6 / k1_heaviest:.3f} ns per heaviest-stream op",
                  flush=True)
        probe_launches = dict(probes.launches)
        print("probe launches: " + json.dumps(probe_launches), flush=True)
        expected = [*probe_records, *[probes.k1_probe_name(cut, probes.BLOCK_MAJOR, team=team)
                                      for cut in profile_layout.PHASES for team in (False, True)]]
        missing = [name for name in expected if probe_launches.get(name, 0) == 0]
        if missing:
            raise AssertionError(f"probe kernels never launched in the probe phase: {missing}")

    # ---- the traces, after every timed phase: a torch.profiler session
    # leaves the host slower at each later launch (its CUPTI subscription),
    # which would stretch every host-bound phase after it ----
    with Phase("traces: a K3-lane unroll; the rank check's minibatch update"):
        # one T=20 unroll under profiling.trace, with tools/profile_unroll.py's
        # busy time and idle share (the union of the device intervals over
        # the CUDA-event window)
        state, key_t = wrapped.reset(env_keys(B)), next_key()
        with profiling.trace(TRACE_DIR, "k3_lane_unroll", device=device) as tr:
            lane.unroll(state, params, key_t, T_UNROLL)
        unroll_trace = print_trace(f"K3 lane unroll T={T_UNROLL} x {B} envs", tr)
        traced_k3 = trace_launches(unroll_trace, "wrapped_step_team_kernel")
        print(f"K3 lane unroll trace: team K3 launches {traced_k3} (expected {T_UNROLL}), "
              f"threefry launches {trace_launches(unroll_trace, 'threefry_kernel')}, idle share "
              f"{unroll_trace['idle']:.4f} (1 - busy / window, profile_unroll's)", flush=True)
        if traced_k3 != T_UNROLL:
            raise AssertionError(f"the unroll's trace holds {traced_k3} team K3 launches, "
                                 f"expected {T_UNROLL}")
        # the rank path in one process: one minibatch update (with the
        # normalizer's update and the batch's gather) under a one-rank NCCL
        # group, bit for bit the single-process update on the same data and
        # keys; the single-process update traced
        one_rank_update_check(lane, wrapped, params, *rank_keys, tc, device,
                              trace_dir=TRACE_DIR)

    # team K3's record counts the one-thread program's operations: the same work
    k3_ops = build.last_build["wrapped_step_team"]["ops_per_env"]
    if k3_ops != build.last_build["wrapped_step"]["ops_per_env"]:
        raise AssertionError("team K3's and the one-thread K3's operation counts differ")
    k3_bound, k3_by = bound_ms(k3_ops, *(sum(r) for r in soa_env.block_rows(s, es)), B)
    k2_bound, k2_by = bound_ms(build.last_build["env_step"]["ops_per_env"],
                               *(sum(r) for r in soa_env.env_block_rows(s, es)), EVAL_ENVS)
    k1_bound, k1_by = bound_ms(build.last_build["physics_step"]["ops_per_env"],
                               *(sum(r) for r in soa.physics_block_rows(s1)), B)
    k1_bound_small, _ = bound_ms(build.last_build["physics_step"]["ops_per_env"],
                                 *(sum(r) for r in soa.physics_block_rows(s1)), EVAL_ENVS)
    # K4: T steps of K3's body and the policy per env; reads the carry, the
    # reset rows, the DR rows, T steps of noise and eps and the weights once,
    # writes the final carry and T steps of obs, act, raw, logp and aux
    # (per T=4 unroll, the K4 check's, where the plain version was timed)
    dims = [env.observation_size] + [w.shape[0] for w, _ in layers]
    k4_ops = T_CHECK * (build.last_build["fused_unroll"]["ops_per_env"]
                        + fused_unroll.policy_op_count(dims, activation, env.action_size, False))
    in_rows, out_rows = soa_env.block_rows(s, es)
    carry_rows = s.nq + s.nv + es.nenv_rows + 2
    k4_in_rows = (carry_rows + in_rows[6] + in_rows[5] + T_CHECK * (in_rows[4] + in_rows[2])
                  + sum(w.numel() + b.numel() for w, b in layers) / B)
    k4_out_rows = carry_rows + T_CHECK * (es.hist + 2 * env.action_size + 1 + out_rows[4])
    k4_bound, k4_by = bound_ms(k4_ops, k4_in_rows, k4_out_rows, B)
    kernels = [{
        # jax's threefry: every draw of the port, on the card; it replaces no
        # pallas_call (jax.random lowers to XLA's own threefry)
        "name": "threefry",
        "route": "cuda",
        "source": "puppax_torch/csrc/threefry.cuh",
        "replaces": "none: jax/_src/prng.py:1092 threefry_2x32 (XLA, no pallas_call)",
        "launches": threefry_launches["ppo.train"],
        "max_abs_err": tf["max_abs_err"],
        "ms": tf["ms"],
        "plain_ms": tf["plain_ms"],
        "bound_ms": tf["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        # K3, K2 and K1 as the team kernels (the main path) and as the
        # one-thread kernels (their A/B baseline, launched 0 times on the main
        # path); max_abs_err is the largest of the widths held against plain
        "name": "wrapped_step_team",
        "route": "cuda",
        "source": "puppax_torch/csrc/wrapped_step_team.cuh",
        "replaces": "puppax/env/soa_env.py:877",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": statistics.median(k3_ms),
        "plain_ms": statistics.median(k3_plain_ms),
        "bound_ms": k3_bound,
        "bound_by": k3_by,
        "library_ms": None,
    }, {
        "name": "wrapped_step",
        "route": "cuda",
        "source": "puppax_torch/csrc/wrapped_step.cuh",
        "replaces": "puppax/env/soa_env.py:877",
        "launches": k3_one_launches,
        "max_abs_err": k3_one_err,
        "ms": statistics.median(k3_one_ms),
        "plain_ms": statistics.median(k3_plain_ms),
        "bound_ms": k3_bound,
        "bound_by": k3_by,
        "library_ms": None,
    }, {
        "name": "env_step_team",
        "route": "cuda",
        "source": "puppax_torch/csrc/env_step_team.cuh",
        "replaces": "puppax/env/soa_env.py:533",
        "launches": k2_launches,
        "visualize_launches": vis_launches["team K2"],
        "max_abs_err": max(k2_err, k2_err_4096),
        "ms": statistics.median(k2_ms),
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "env_step",
        "route": "cuda",
        "source": "puppax_torch/csrc/env_step.cuh",
        "replaces": "puppax/env/soa_env.py:533",
        "launches": k2_one_launches,
        "max_abs_err": max(k2_one_err, k2_one_err_4096),
        "ms": statistics.median(k2_one_ms),
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }, {
        "name": "physics_step_team",
        "route": "cuda",
        "source": "puppax_torch/csrc/physics_step_team.cuh",
        "replaces": "puppax/physics/soa.py:2028",
        "launches": k1_launches,
        "max_abs_err": max(k1_err, k1_err_small),
        "ms": statistics.median(k1_ms),
        "plain_ms": statistics.median(k1_plain_ms),
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "physics_step",
        "route": "cuda",
        "source": "puppax_torch/csrc/physics_step.cuh",
        "replaces": "puppax/physics/soa.py:2028",
        "launches": k1_one_launches,
        "max_abs_err": max(k1_one_err, k1_one_err_small),
        "ms": statistics.median(k1_one_ms),
        "plain_ms": statistics.median(k1_plain_ms),
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        # K4 as the team kernel (the main path) and the one-thread kernel
        "name": "fused_unroll_team",
        "route": "cuda",
        "source": "puppax_torch/csrc/fused_unroll_team.cuh",
        "replaces": "puppax/env/fused_unroll.py:152",
        "launches": k4_launches,
        "max_abs_err": k4_err,
        "ms": statistics.median(k4_ms),
        "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound,
        "bound_by": k4_by,
        "library_ms": None,
    }, {
        "name": "fused_unroll",
        "route": "cuda",
        "source": "puppax_torch/csrc/fused_unroll.cuh",
        "replaces": "puppax/env/fused_unroll.py:152",
        "launches": k4_one_launches,
        "max_abs_err": k4_one_err,
        "ms": statistics.median(k4_one_ms),
        "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound,
        "bound_by": k4_by,
        "library_ms": None,
    }]

    # run12's bodies: team K3 and K4 (one-thread beside them) with history 4
    # and the privileged rows, team K2 with history 4. Team K3's and team
    # K2's launches are the run12 CLI's K3-lane run's (K2 in its
    # evaluations), named in "launches_in", team K4's the fused lane's;
    # K4's ms, plain_ms and bound_ms are per T=4 unroll, the K4 check's
    in12, out12 = soa_env.block_rows(s12, es12)
    k3_12_bound = bound_ms(build.last_build[rec12["team K3[run12]"]]["ops_per_env"],
                           sum(in12), sum(out12), B)
    k2_12_bound = bound_ms(build.last_build[rec12["team K2[hist4]"]]["ops_per_env"],
                           *(sum(r) for r in soa_env.env_block_rows(s12, es12)), EVAL_ENVS)
    dims12 = [env12.observation_size] + [w.shape[0] for w, _ in layers12]
    k4_12_ops = T_CHECK * (build.last_build[rec12["K4[run12]"]]["ops_per_env"]
                            + fused_unroll.policy_op_count(dims12, activation, env12.action_size,
                                                           True))
    carry12_rows = s12.nq + s12.nv + es12.nenv_rows + 2 + 1  # and the clock's phase row
    k4_12_in = (carry12_rows + in12[6] + in12[5] + T_CHECK * (in12[4] + in12[2])
                + sum(w.numel() + b.numel() for w, b in layers12) / B)
    k4_12_out = carry12_rows + T_CHECK * (env12.observation_size + 2 * env12.action_size + 1
                                           + out12[4])
    k4_12_bound = bound_ms(k4_12_ops, k4_12_in, k4_12_out, B)
    k3_run, k4_run = "run12 training, K3 lane", "run12 training, fused-unroll lane"
    for name, source, replaces, launches_, run, err, ms, plain, bound in (
            ("wrapped_step_team[run12]", "wrapped_step_team.cuh", "puppax/env/soa_env.py:877",
             k3_12_launches, k3_run, k3_12_err, statistics.median(k3_12_ms), k3_12_plain_ms,
             k3_12_bound),
            ("wrapped_step[run12]", "wrapped_step.cuh", "puppax/env/soa_env.py:877", 0, k3_run,
             k3_12_one_err, statistics.median(k3_12_one_ms), k3_12_plain_ms, k3_12_bound),
            ("env_step_team[hist4]", "env_step_team.cuh", "puppax/env/soa_env.py:533",
             k2_12_launches, k3_run, k2_12_err, statistics.median(k2_12_ms), k2_12_plain_ms,
             k2_12_bound),
            ("fused_unroll_team[run12]", "fused_unroll_team.cuh",
             "puppax/env/fused_unroll.py:152", k4_12_launches, k4_run, k4_12_err,
             statistics.median(k4_12_ms), k4_12_plain_ms, k4_12_bound),
            ("fused_unroll[run12]", "fused_unroll.cuh", "puppax/env/fused_unroll.py:152", 0,
             k4_run, k4_12_one_err, statistics.median(k4_12_one_ms), k4_12_plain_ms,
             k4_12_bound)):
        kernels.append({"name": name, "route": "cuda", "source": f"puppax_torch/csrc/{source}",
                        "replaces": replaces, "launches": launches_, "launches_in": run,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                        "bound_by": bound[1], "library_ms": None})

    # run9's eight [hfield] bodies: team K3's and team K2's launches are the
    # run9 CLI's K3-lane run's (K2 in its evaluations); K1 and K4 are not on
    # that lane. K4's numbers are per T=4 unroll, K2's at 128 envs
    in9, out9 = soa_env.block_rows(s9, es9)

    def ops9(label):
        return build.last_build[rec9[label]]["ops_per_env"]

    dims9 = [env9.observation_size] + [w.shape[0] for w, _ in layers9]
    carry9_rows = s9.nq + s9.nv + es9.nenv_rows + 2
    bounds9 = {
        "K1": bound_ms(ops9("K1[hfield]"), *(sum(r) for r in soa.physics_block_rows(s9)), B),
        "K2": bound_ms(ops9("K2[hfield]"), *(sum(r) for r in soa_env.env_block_rows(s9, es9)),
                       EVAL_ENVS),
        "K3": bound_ms(ops9("K3[hfield]"), sum(in9), sum(out9), B),
        "K4": bound_ms(T_CHECK * (ops9("K4[hfield]") + fused_unroll.policy_op_count(
            dims9, activation, env9.action_size, False)),
            carry9_rows + in9[6] + in9[5] + T_CHECK * (in9[4] + in9[2])
            + sum(w.numel() + b.numel() for w, b in layers9) / B,
            carry9_rows + T_CHECK * (es9.hist + 2 * env9.action_size + 1 + out9[4]), B),
    }
    run9 = "run9 training, K3 lane"
    for k, source, replaces, launches_ in (
            ("K1", "physics_step", "puppax/physics/soa.py:2028", (0, 0)),
            ("K2", "env_step", "puppax/env/soa_env.py:533", (k2_9_launches, 0)),
            ("K3", "wrapped_step", "puppax/env/soa_env.py:877", (k3_9_launches, 0)),
            ("K4", "fused_unroll", "puppax/env/fused_unroll.py:152", (0, 0))):
        r = res9[k]
        for team, n in zip((True, False), launches_):
            kernels.append({
                "name": f"{source}{'_team' if team else ''}[hfield]", "route": "cuda",
                "source": f"puppax_torch/csrc/{source}{'_team' if team else ''}.cuh",
                "replaces": replaces, "launches": n, "launches_in": run9 if n else None,
                "max_abs_err": r["err" if team else "one_err"],
                "ms": statistics.median(r["ms" if team else "one_ms"]), "plain_ms": r["plain_ms"],
                "bound_ms": bounds9[k][0], "bound_by": bounds9[k][1], "library_ms": None})

    # run8's three [boxes] bodies, the default lane's: team K3's and team
    # K2's launches are the run8 CLI's (K2 in its evaluations); K2's numbers
    # at 128 envs
    in8, out8 = soa_env.block_rows(s8, es8)
    bounds8 = {
        "K3": bound_ms(build.last_build[rec8["K3[boxes]"]]["ops_per_env"], sum(in8), sum(out8), B),
        "K2": bound_ms(build.last_build[rec8["team K2[boxes]"]]["ops_per_env"],
                       *(sum(r) for r in soa_env.env_block_rows(s8, es8)), EVAL_ENVS),
        "K1": bound_ms(build.last_build[rec8["team K1[boxes]"]]["ops_per_env"],
                       *(sum(r) for r in soa.physics_block_rows(s8)), B),
    }
    # team K4[boxes] per T=4 unroll: T steps of K3[boxes]'s program and the
    # policy; the carry, reset and DR rows, T steps of noise and eps and the
    # weights read once, the final carry and T steps of the outputs written
    dims8 = [env8.observation_size] + [w.shape[0] for w, _ in layers8]
    carry8_rows = s8.nq + s8.nv + es8.nenv_rows + 2
    bounds8["K4"] = bound_ms(
        T_CHECK * (build.last_build[rec8["team K4[boxes]"]]["ops_per_env"]
                   + fused_unroll.policy_op_count(dims8, activation, env8.action_size, False)),
        carry8_rows + in8[6] + in8[5] + T_CHECK * (in8[4] + in8[2])
        + sum(w.numel() + b.numel() for w, b in layers8) / B,
        carry8_rows + T_CHECK * (es8.hist + 2 * env8.action_size + 1 + out8[4]), B)
    run8 = "run8 training, K3 lane"
    for name, source, replaces, k, team, n in (
            ("wrapped_step_team[run8]", "wrapped_step_team.cuh", "puppax/env/soa_env.py:877",
             "K3", True, k3_8_launches),
            ("wrapped_step[run8]", "wrapped_step.cuh", "puppax/env/soa_env.py:877", "K3", False,
             0),
            ("env_step_team[run8]", "env_step_team.cuh", "puppax/env/soa_env.py:533", "K2", True,
             k2_8_launches)):
        r = res8[k]
        kernels.append({
            "name": name, "route": "cuda", "source": f"puppax_torch/csrc/{source}",
            "replaces": replaces, "launches": n, "launches_in": run8 if n else None,
            "max_abs_err": r["err" if team else "one_err"],
            "ms": statistics.median(r["ms" if team else "one_ms"]), "plain_ms": r["plain_ms"],
            "bound_ms": bounds8[k][0], "bound_by": bounds8[k][1], "library_ms": None})
    # the physics-only lane's team K1[boxes] (its time and bound at 4096
    # envs, ms_128 at the evaluator's 128) and the fused lane's team
    # K4[boxes] (per T=4 unroll; its plain version timed on the T=2 check)
    for name, source, replaces, k, n, run in (
            ("physics_step_team[run8]", "physics_step_team.cuh", "puppax/physics/soa.py:2028",
             "K1", k1_8_launches, "run8 training, physics-only lane"),
            ("fused_unroll_team[run8]", "fused_unroll_team.cuh",
             "puppax/env/fused_unroll.py:152", "K4", k4_8_launches,
             "run8 training, fused-unroll lane")):
        r = res8[k]
        entry = {
            "name": name, "route": "cuda", "source": f"puppax_torch/csrc/{source}",
            "replaces": replaces, "launches": n, "launches_in": run, "max_abs_err": r["err"],
            "ms": statistics.median(r["ms"]), "plain_ms": r["plain_ms"],
            "bound_ms": bounds8[k][0], "bound_by": bounds8[k][1], "library_ms": None,
            **build_numbers(rec8[f"team {k}[boxes]"])}
        if k == "K1":
            entry["ms_128"] = statistics.median(r["ms_small"])
        else:
            entry["plain_unroll_T"] = RUN8_K4_PLAIN_T
        kernels.append(entry)

    # the capsule model's four team bodies, each launched in its lane's CLI
    # run (team K2's in the K3 lane's evaluation); K2 at 128 envs, K4 per
    # T=4 unroll (its plain version timed on that T=4 check)
    inc, outc = soa_env.block_rows(sc, esc)
    dims_c = [env_c.observation_size] + [w.shape[0] for w, _ in layers_c]
    carry_c_rows = sc.nq + sc.nv + esc.nenv_rows + 2

    def ops_c(k):
        return build.last_build[recc[k]]["ops_per_env"]

    bounds_c = {
        "K3": bound_ms(ops_c("K3"), sum(inc), sum(outc), B),
        "K2": bound_ms(ops_c("K2"), *(sum(r) for r in soa_env.env_block_rows(sc, esc)),
                       EVAL_ENVS),
        "K1": bound_ms(ops_c("K1"), *(sum(r) for r in soa.physics_block_rows(sc)), B),
        "K4": bound_ms(
            T_CHECK * (ops_c("K4") + fused_unroll.policy_op_count(dims_c, activation,
                                                                  env_c.action_size, False)),
            carry_c_rows + inc[6] + inc[5] + T_CHECK * (inc[4] + inc[2])
            + sum(w.numel() + b.numel() for w, b in layers_c) / B,
            carry_c_rows + T_CHECK * (esc.hist + 2 * env_c.action_size + 1 + outc[4]), B),
    }
    for k, source, replaces, n, run in (
            ("K3", "wrapped_step_team", "puppax/env/soa_env.py:877", k3_c_launches,
             "capsule training, K3 lane"),
            ("K2", "env_step_team", "puppax/env/soa_env.py:533", k2_c_launches,
             "capsule training, K3 lane"),
            ("K1", "physics_step_team", "puppax/physics/soa.py:2028", k1_c_launches,
             "capsule training, physics-only lane"),
            ("K4", "fused_unroll_team", "puppax/env/fused_unroll.py:152", k4_c_launches,
             "capsule training, fused-unroll lane")):
        r = res_c[k]
        entry = {
            "name": f"{source}[capsule]", "route": "cuda",
            "source": f"puppax_torch/csrc/{source}.cuh", "replaces": replaces, "launches": n,
            "launches_in": run, "max_abs_err": r["err"], "ms": statistics.median(r["ms"]),
            "plain_ms": r["plain_ms"], "bound_ms": bounds_c[k][0], "bound_by": bounds_c[k][1],
            "library_ms": None, **build_numbers(recc[k])}
        if k == "K1":
            entry["ms_128"] = statistics.median(r["ms_small"])
        if k == "K4":
            entry["plain_unroll_T"] = T_CHECK
        kernels.append(entry)

    def probe_entry(name, source, replaces, err, ms, plain_ms, bound, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"puppax_torch/csrc/{source}",
                "replaces": replaces, "launches": probe_launches.get(name, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms}

    k1_rows = [sum(soa.physics_block_rows(s1)[0]), sum(probes.probe_out_rows(s1))]

    def k1_bound_of(record):
        return bound_ms(build.last_build[record]["ops_per_env"], *k1_rows, B)

    # the phase cuts and the block-major fk and full, one-thread (128
    # threads) and team; a design's cut runs one program: the cut's bound
    designs = (
        (False, "probe_physics.cuh", lambda cut: layouts[(cut, probes.BLOCK_MAJOR, 128)]),
        (True, "probe_physics_team.cuh", lambda cut: team_layouts[(cut, probes.BLOCK_MAJOR)]),
    )
    for team, source, _ in designs:
        for cut in soa.PHASES:
            name = probes.k1_probe_name(cut, team=team)
            res = cuts[cut]["team" if team else "one-thread"]
            kernels.append(probe_entry(
                name, source, "dev/profile_kernel_phases.py:68", res["max_abs_err"],
                res["us"] / 1e3, cuts[cut]["plain_ms"], k1_bound_of(probe_records[name])))
    for team, source, block_major in designs:
        for cut in profile_layout.PHASES:
            lay = block_major(cut)
            kernels.append(probe_entry(
                probes.k1_probe_name(cut, probes.BLOCK_MAJOR, team=team), source,
                "dev/profile_layout.py:113", lay["max_abs_err"], lay["us"] / 1e3,
                cuts[cut]["plain_ms"],
                k1_bound_of(probe_records[probes.k1_probe_name(cut, team=team)])))
    # K1 under --fmad=true, one thread per env and team K1's: its distance
    # from the --fmad=false build is the error reported (run_k1 holds the
    # envs outside the movement tolerance to MAX_DIFFERING_ENVS)
    for team, source, half in ((False, "probe_physics.cuh", k1_fmad),
                               (True, "probe_physics_team.cuh", k1_fmad["team"])):
        fmad_name = probes.k1_probe_name(None, fmad=True, team=team)
        kernels.append(probe_entry(
            fmad_name, source, "dev/probe_fma_fusion.py:47",
            max(half["max_q"], half["max_v"], half["max_caches"]), half["ms_on"],
            cuts[None]["plain_ms"], k1_bound_of(probe_records[fmad_name])))
    # the chain's muladd on the TPU's grid in both designs; its bound is the
    # FP32 issue floor at clocks.max.sm (one instruction per lane per clock:
    # K FFMA contracted, 2K FMUL / FADD not), which the bytes never reach
    for one_element in (False, True):
        for fmad in (False, True):
            res = chain[("tpu", "muladd", fmad, "one-element" if one_element else "redesign")]
            kernels.append(probe_entry(
                probe_fma_fusion.chain_name(fmad, one_element), "probe_fma.cuh",
                "dev/probe_fma_fusion.py:47", res["max_abs_err"], res["ms"], res["plain_ms"],
                (res["issue_floor_us"] / 1e3, "operations")))
    # x + 1 in both designs at nb = 32, the redesign with PDL, and torch's
    # x + 1 (its plain version and the one library call of the same
    # function) from CUDA graphs, timed in turns: the device's, not the host's
    add = overhead["add_one_nb32"]["designs"]
    torch_ms = add["torch.add"][1] / 1e3
    for name, design in (("add_one", "PDL"), (probe_launch_overhead.ONE_ELEMENT, "one-element")):
        kernels.append(probe_entry(
            name, "probe_add_one.cuh", "dev/probe_launch_overhead.py:48",
            max(r[design][0] for r in overhead["check"].values()), add[design][1] / 1e3,
            torch_ms, bound_ms(1, 1, 1, overhead["add_one_nb32"]["numel"]), library_ms=torch_ms))
    # the copies: one add per q (and v) row and per summed ctrl and dr row;
    # times from CUDA graphs; copy_q's library twin is torch.add(q, 1e-7)
    cq = scan["copy_q"]
    kernels.append(probe_entry(
        "copy_q", "probe_copy.cuh", "dev/profile_scan.py:88", cq["max_abs_err"],
        cq["graph_us"] / 1e3, cq["plain_ms"], bound_ms(s1.nq, s1.nq, s1.nq, B),
        library_ms=cq["library_us"][1] / 1e3))
    qv = s1.nq + s1.nv
    full_in = qv + s1.nu + s1.ndr  # rows read, and adds
    for name, replaces, bound in (
            ("copy_min", "dev/profile_overhead.py:120", bound_ms(qv, qv, qv, B)),
            ("copy_full", "dev/profile_overhead.py:98",
             bound_ms(full_in, full_in, qv + s1.ncache + 1, B)),
            ("copy_full_one_block", "dev/profile_overhead.py:163",
             bound_ms(full_in, full_in, qv + s1.ncache + 1, probes.TILE))):
        res = copies[name]
        kernels.append(probe_entry(name, "probe_copy.cuh", replaces, res["max_abs_err"],
                                   res["graph_us"] / 1e3, res["plain_ms"], bound))
    # P7, the fk cut: the one-thread cut and the team build with its substep
    # loop partitioned, timed in turns from CUDA graphs (the fk cut's bound)
    fk_checks = copies["fk"]["checks"]
    for name, source, res, err in (
            (profile_overhead.FK, "probe_physics.cuh", copies["fk"],
             max(c["one_thread"]["max_abs_err"] for c in fk_checks.values())),
            (profile_overhead.FK_TEAM, "probe_physics_team.cuh", copies["fk_team"],
             max(c["max_abs_err"] for c in fk_checks.values()))):
        kernels.append(probe_entry(
            name, source, "dev/profile_overhead.py:138", err, res["graph_us"] / 1e3,
            fk_checks[B]["plain_ms"], k1_bound_of(probe_records[profile_overhead.FK])))
    # the SoA substep reads q and v and writes q; the solve reads A's
    # triangle on and below the diagonal and b, and writes x; times from
    # CUDA graphs; the solve's library twin is torch.linalg.solve_ex, the one
    # PyTorch call of the same function
    soa60 = soa_res[soa_probe.ROUNDS]
    kernels.append(probe_entry(
        soa_probe.soa_name(), "probe_soa.cuh", "dev/pallas_soa_probe.py:103",
        max(c["max_abs_err"] for c in soa60["checks"].values()), soa60["graph_us"] / 1e3,
        soa60["plain_ms"], bound_ms(soa60["ops_per_env"], soa_probe.NQ + soa_probe.NV,
                                    soa_probe.NQ, B)))
    soa_t = soa60["team"][soa_probe.TEAM_WARPS]
    kernels.append(probe_entry(
        soa_probe.soa_name(team=True), "probe_soa_team.cuh", "dev/pallas_soa_probe.py:103",
        max(c["max_abs_err"] for c in soa_t["checks"].values()), soa_t["graph_us"] / 1e3,
        soa_t["plain_ms"], bound_ms(soa_t["ops_per_env"], soa_probe.NQ + soa_probe.NV,
                                    soa_probe.NQ, B)))
    spd_bound = bound_ms(spd_res["ops_per_env"], *spd_probe.spd_rows(), B)
    kernels.append(probe_entry(
        "spd_solve", "probe_spd_warp.cuh", "dev/pallas_spd_poc.py:57",
        max(c["max_abs_err"] for c in spd_res["checks"].values()), spd_res["graph_us"] / 1e3,
        spd_res["plain_ms"], spd_bound, library_ms=spd_res["solve_ex_us"][1] / 1e3))
    kernels.append(probe_entry(
        "spd_solve[one-thread]", "probe_spd.cuh", "dev/pallas_spd_poc.py:57",
        max(c["one_thread"]["max_abs_err"] for c in spd_res["checks"].values()),
        spd_res["one_thread_us"][1] / 1e3, spd_res["plain_ms"], spd_bound,
        library_ms=spd_res["solve_ex_us"][1] / 1e3))
    print(f"bounds (team and one-thread alike): K3 {k3_bound:.6f} ms at {B} envs ({k3_by}), "
          f"K2 {k2_bound:.6f} ms at "
          f"{EVAL_ENVS} envs ({k2_by}), K1 {k1_bound:.6f} ms at {B} envs ({k1_by}) and "
          f"{k1_bound_small:.6f} ms at {EVAL_ENVS}, K4 {k4_bound:.6f} ms per T={T_CHECK} "
          f"unroll at {B} envs ({k4_by}); run12: team K3 {k3_12_bound[0]:.6f} ms, team K2 "
          f"(history 4) {k2_12_bound[0]:.6f} ms at {EVAL_ENVS} envs, team K4 "
          f"{k4_12_bound[0]:.6f} ms per unroll; run9: team K1 {bounds9['K1'][0]:.6f} ms, "
          f"team K2 {bounds9['K2'][0]:.6f} ms at {EVAL_ENVS} envs, team K3 "
          f"{bounds9['K3'][0]:.6f} ms, team K4 {bounds9['K4'][0]:.6f} ms per unroll; run8: team "
          f"K3 {bounds8['K3'][0]:.6f} ms ({bounds8['K3'][1]}), team K2 {bounds8['K2'][0]:.6f} ms "
          f"at {EVAL_ENVS} envs ({bounds8['K2'][1]}), team K1 {bounds8['K1'][0]:.6f} ms "
          f"({bounds8['K1'][1]}), team K4 {bounds8['K4'][0]:.6f} ms per unroll "
          f"({bounds8['K4'][1]}); capsule: team K3 {bounds_c['K3'][0]:.6f} ms, team K2 "
          f"{bounds_c['K2'][0]:.6f} ms at {EVAL_ENVS} envs, team K1 {bounds_c['K1'][0]:.6f} ms, "
          f"team K4 {bounds_c['K4'][0]:.6f} ms per unroll", flush=True)
    print(f"first batch {first_batch_s:.1f} s ({len(batch)} bodies); total wall "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    # K4's times and bound are per unroll of T_CHECK steps in every K4
    # entry, its plain version's per unroll of the check's plain_unroll_T
    for k in kernels:
        if k["source"].startswith("puppax_torch/csrc/fused_unroll"):
            k["unroll_T"] = T_CHECK
            k.setdefault("plain_unroll_T", T_PLAIN)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
