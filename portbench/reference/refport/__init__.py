"""refport: a frozen copy of the plain path of puppax_torch (commit 1ec45da).

The benchmark's reference, copied with the package name changed. It keeps
what the reference runs: the keys and threefry draws (their plain
version on every device, ``random.threefry``), the env's reset and DR,
the env step as torch ops (``PupperV3Env._step_core``) around the physics
pipeline (``physics/pipeline.py::pipeline_step``: ``smooth``,
``collision``, ``constraint``, ``solver``), which runs in the state's
dtype, float64 included, the networks and the action distribution. The
kernels' emission, their builders, the process group and the lane
switches are left out. It imports nothing of ``puppax_torch`` or
``puppax``; later changes to the program do not reach it.
"""
