"""Framework exceptions of the port (counterpart of ``p2pfl_tpu/exceptions.py``).

Only what the ported slices raise lives here.
"""


class DeviceUnavailableError(RuntimeError):
    """Raised when an entry point is asked for a CUDA device and none exists.

    The port never falls back to the CPU on its own: a caller that wants
    the plain PyTorch versions passes ``device="cpu"``.
    """


class KernelBuildError(RuntimeError):
    """Raised when ``nvcc`` cannot build the CUDA kernels from ``csrc/``."""


class NodeRunningException(Exception):
    """``Node.start`` on a node that is already running."""


class ZeroRoundsException(Exception):
    """``set_start_learning`` with fewer than one round."""


class ModelNotMatchingError(Exception):
    """Incoming parameters do not match the learner's model structure."""


class DecodingParamsError(Exception):
    """A serialized weights payload cannot be decoded (bad magic, CRC,
    header, truncation, a dtype torch cannot hold)."""


class AnchorMismatchError(Exception):
    """A delta-coded (topk8) payload names another round-start anchor than
    the receiver holds. Not fatal, unlike :class:`DecodingParamsError`: the
    receiver skips the update and waits for one it can reconstruct."""


class SecAggError(Exception):
    """A secure-aggregation contribution cannot be masked safely. The
    caller must not send it unmasked (peers' halves of the pair masks would
    go uncancelled and turn a full-coverage aggregate into noise): it skips
    the contribution, which leaves coverage incomplete and detectable."""


class NeighborNotConnectedError(Exception):
    """The transport cannot reach the requested peer."""


class UnsupportedByPortError(ValueError):
    """A configuration the JAX package supports but the port does not yet
    (the DCN plane, churn, ...):
    raised at ``Node.start`` or where it is configured, never in the
    middle of a round."""
