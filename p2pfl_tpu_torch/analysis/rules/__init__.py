"""Built-in rule registry: one module a contract (the JAX package's
``send-under-lock``, ``monotone-merge``, ``wire-header-compat`` and
``no-host-gather``); ``tests/test_torch_analysis.py`` pins both directions
of each (the bug's shape flags, the shipped fix passes). Order here is the
report order of ``--list-rules``.
"""

from p2pfl_tpu_torch.analysis.rules.concurrency import SendUnderLockRule
from p2pfl_tpu_torch.analysis.rules.hostgather import NoHostGatherRule
from p2pfl_tpu_torch.analysis.rules.merge import MonotoneMergeRule
from p2pfl_tpu_torch.analysis.rules.wire import WireHeaderCompatRule

ALL_RULES = (
    SendUnderLockRule,
    MonotoneMergeRule,
    WireHeaderCompatRule,
    NoHostGatherRule,
)

__all__ = [
    "ALL_RULES",
    "MonotoneMergeRule",
    "NoHostGatherRule",
    "SendUnderLockRule",
    "WireHeaderCompatRule",
]
