"""Kernel-time probes: H100 counterparts of the Pallas probes in ``dev/``.

Each module asks on the card the question its TPU original asked, with a
hand-written CUDA kernel, a plain PyTorch version beside it, a ``run``
function (``chip_smoke.py`` drives it) and a command line
(``python -m puppax_torch.probes.<name>``, on ``cuda:0``):

- ``profile_kernel_phases``: K1 cut after each physics phase, timed
  (``dev/profile_kernel_phases.py``);
- ``profile_layout``: K1 in row-major and block-major layouts at 32, 64 and
  128 threads per block (``dev/profile_layout.py``);
- ``probe_fma_fusion``: a dependent multiply-add chain and K1 under
  ``--fmad=false`` and ``--fmad=true`` (``dev/probe_fma_fusion.py``);
- ``probe_launch_overhead``: an ``x + 1`` kernel, K1 and a torch
  elementwise body, 50 launches eager and as one CUDA graph
  (``dev/probe_launch_overhead.py``).

The probes' builds are their own libraries (``kernels/build.py``); the
production kernels K1-K4 and their flags are untouched by them.
"""
