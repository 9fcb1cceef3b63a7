"""The policy export: a trained policy -> the on-robot JSON policy, and the
native runtime that replays it.

Counterpart of ``puppax/export/``: ``params`` (the JSON ABI, in numpy) and
``native`` (ctypes over ``native/policy_runtime.cc``, built with g++ into
``build/``). The command line is ``python -m puppax_torch.scripts.export_policy``.
"""

from puppax_torch.export.params import (  # noqa: F401
    apply_exported_policy,
    convert_params,
    fold_in_normalization,
)
