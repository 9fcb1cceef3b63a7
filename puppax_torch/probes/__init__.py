"""Kernel-time probes: H100 counterparts of the Pallas probes in ``dev/``.

Each module asks on the card the question its TPU original asked, with a
hand-written CUDA kernel, a plain PyTorch version beside it, a ``run``
function (``chip_smoke.py`` drives it) and a command line
(``python -m puppax_torch.probes.<name>``, on ``cuda:0``):

- ``profile_kernel_phases``: K1 cut after each physics phase, timed in
  the production K1's team design (its program split across the warps of
  a block, ``csrc/probe_physics_team.cuh``) beside one thread per env
  (``csrc/probe_physics.cuh``, the A/B) (``dev/profile_kernel_phases.py``);
- ``profile_layout``: K1 in row-major and block-major layouts at 32, 64 and
  128 threads per block, and the team fk and full cuts in both layouts
  (``dev/profile_layout.py``);
- ``probe_fma_fusion``: a dependent multiply-add chain (8 interleaved
  elements per thread on the resident blocks, beside one element per
  thread) and K1 (one-thread and team) under ``--fmad=false`` and
  ``--fmad=true`` (``dev/probe_fma_fusion.py``);
- ``probe_launch_overhead``: an ``x + 1`` kernel, K1 and a torch
  elementwise body, 50 launches eager and as one CUDA graph
  (``dev/probe_launch_overhead.py``);
- ``profile_overhead``: a copy kernel over K1's operand set, over q and v
  only and at one block, beside K1 cut after FK, one thread per env and as
  a team build whose substep loop is partitioned across the warps
  (``dev/profile_overhead.py``);
- ``profile_scan``: the copy and torch bodies eager and graphed, and the K3
  lane's T=20 unroll eager against one captured CUDA graph
  (``dev/profile_scan.py``);
- ``profile_boundary``: K1 on ``(rows, B)`` carries, behind per-step
  transposes, the transposes alone and the physics-only lane's splice
  (``dev/profile_boundary.py``);
- ``probe_degradation``: the copy's launch cost after each setup stage, a
  fresh process each (set up together, timed in turn), and around a host
  sync (``dev/probe_degradation.py``).
- ``pallas_soa_probe``: a synthetic SoA substep emitted as one
  straight-line body per env, one thread per env and as a team kernel,
  its nvcc time and throughput against the body's size
  (``dev/pallas_soa_probe.py``);
- ``pallas_spd_poc``: the batched 18 x 18 SPD solve of the Newton step, one
  warp per env (lane i owns row i) and one thread per env, beside
  ``solve_ex`` and cuSOLVER's pair (``dev/pallas_spd_poc.py``).

Two probes have no TPU original; they ask the team kernels' questions
(K1 and K2 split across the warps of a block, ``kernels/team.py``):
``profile_layout --team`` sweeps the warps per block, and
``profile_team`` the schedule's knobs (stage budget, crossing cost, shared
memory budget, the row sums' unroll) and prices the line search;
``profile_team --kernel P7`` sweeps P7's team fk build by W and stage
budget.

The probes' builds are their own libraries (``kernels/build.py``); the
production kernels K1-K4 and their flags are untouched by them.
"""
