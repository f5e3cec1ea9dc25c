"""p2pfl_tpu_torch: the PyTorch/CUDA port of :mod:`p2pfl_tpu`.

A second package beside the JAX one, held against it by the tests in
``tests/test_torch_*.py``. Module layout and names follow the JAX package
so a reader finds each counterpart by path; the code inside is PyTorch.
It imports neither JAX nor anything of ``p2pfl_tpu``.

Entry points take ``device=None``, which means ``"cuda"``; without a GPU
they raise (:func:`resolve_device`) instead of carrying on on the CPU.
Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.

Importing the package turns TF32 off in cuBLAS and cuDNN, once: an fp32
product, as ``Settings.COMPUTE_DTYPE="float32"`` asks for, is an IEEE fp32
product on the card as on the CPU (PyTorch's default lets cuDNN run an
fp32 convolution in TF32, 10 mantissa bits). A caller who wants TF32 sets
torch's two flags after the import; nothing in the package sets them again.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from p2pfl_tpu_torch.exceptions import DeviceUnavailableError

__all__ = ["resolve_device", "DeviceUnavailableError"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return dev
