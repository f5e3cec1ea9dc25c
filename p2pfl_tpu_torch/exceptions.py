"""Framework exceptions of the port (counterpart of ``p2pfl_tpu/exceptions.py``).

Only what the ported slice raises lives here.
"""


class DeviceUnavailableError(RuntimeError):
    """Raised when an entry point is asked for a CUDA device and none exists.

    The port never falls back to the CPU on its own: a caller that wants
    the plain PyTorch versions passes ``device="cpu"``.
    """


class KernelBuildError(RuntimeError):
    """Raised when ``nvcc`` cannot build the CUDA kernels from ``csrc/``."""
