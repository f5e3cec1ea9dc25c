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


class NeighborNotConnectedError(Exception):
    """The transport cannot reach the requested peer."""


class UnsupportedByPortError(ValueError):
    """A configuration the JAX package supports but the port does not yet
    (the byte codec, secure aggregation, lossy compression, ...): raised
    at ``Node.start``, never in the middle of a round."""
