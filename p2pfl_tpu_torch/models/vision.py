"""Vision models (counterpart of ``p2pfl_tpu/models/vision.py``): the
MLP, the CNN, ResNet-18/50 and the ViT.

The MLP (784-256-128-10) is the reference's MNIST model and the gossip
Node's model; the two-conv CNN the reference's other MNIST model (the
wrong-model scenario pairs the two); ResNet-18/50 (GroupNorm, CIFAR
shapes) the BASELINE vision federations; the ViT the attention-based
vision model. Compute in bfloat16, parameters and logits in float32, as
in flax: each ``Dense`` and ``Conv`` casts its input, kernel and bias to
the compute dtype, takes the product and adds the bias in that dtype.
Parameters keep flax's names and layout (``Dense_{i}/kernel`` as ``[in,
out]``, ``Conv_{i}/kernel`` as HWIO ``[kh, kw, in, out]``, then ``bias``,
``GroupNorm_{i}/scale``, ``block_{i}/qkv``, the top-level ``pos_embed``),
so JAX init params load 1:1 through :mod:`p2pfl_tpu_torch.convert`.
Images are NHWC, as in flax; inside, activations are NCHW views of
channels-last memory.

Three of flax's conventions differ from PyTorch's defaults, and the
modules follow flax's: ``padding="SAME"`` at stride 2 pads 0 rows
before and 1 after on an even input (:func:`_conv`); ``GroupNorm`` and
``LayerNorm`` use eps 1e-6 with fp32 statistics (:data:`NORM_EPS`);
``nn.gelu`` is the tanh approximation.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.transformer import _lecun_normal
from p2pfl_tpu_torch.settings import Settings


class MLP(nn.Module):
    """Parameter-free module: ``forward(params, x)`` → fp32 logits."""

    def __init__(
        self, hidden: Sequence[int] = (256, 128), num_classes: int = 10, dtype=None
    ) -> None:
        super().__init__()
        self.hidden = tuple(hidden)
        self.num_classes = num_classes
        # None: ``Settings.COMPUTE_DTYPE`` (bfloat16 unless changed)
        self.dtype = getattr(torch, Settings.COMPUTE_DTYPE) if dtype is None else dtype

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.reshape(x.shape[0], -1).to(dt)
        n = len(self.hidden) + 1
        for i in range(n):
            p = params[f"Dense_{i}"]
            x = x @ p["kernel"].to(dt) + p["bias"].to(dt)
            if i < n - 1:
                x = torch.relu(x)
        return x.float()


def init_mlp_params(
    in_features: int, hidden: Sequence[int], num_classes: int, seed: int, device
) -> dict:
    """flax ``Dense`` defaults from a seeded ``torch.Generator``: kernels
    ``lecun_normal``, biases zero (fp32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [in_features, *hidden, num_classes]
    return {
        f"Dense_{i}": {
            "kernel": _lecun_normal((fan_in, fan_out), gen, device),
            "bias": torch.zeros(fan_out, device=device),
        }
        for i, (fan_in, fan_out) in enumerate(zip(sizes, sizes[1:]))
    }


def mlp(seed: int = 0, num_classes: int = 10, input_shape=(28, 28, 1), device=None) -> TorchModel:
    """The MLP bound to fresh parameters on ``device`` (``None`` = cuda)."""
    module = MLP(num_classes=num_classes)
    in_features = 1
    for s in input_shape:
        in_features *= s
    params = init_mlp_params(in_features, module.hidden, num_classes, seed, resolve_device(device))
    return TorchModel(module, params, tuple(input_shape), num_classes)


class CNN(nn.Module):
    """Two 3x3 SAME convolutions (32, 64 channels), each with ReLU and a
    2x2 max pool, then Dense 128, ReLU, Dense ``num_classes``: flax's
    ``CNN`` over NHWC images. ``forward(params, x)`` → fp32 logits."""

    def __init__(self, channels: Sequence[int] = (32, 64), num_classes: int = 10, dtype=None) -> None:
        super().__init__()
        self.channels = tuple(channels)
        self.num_classes = num_classes
        self.dtype = getattr(torch, Settings.COMPUTE_DTYPE) if dtype is None else dtype

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC → NCHW for conv2d
        for i in range(len(self.channels)):
            p = params[f"Conv_{i}"]
            # HWIO → OIHW; the bias is added after the product, in the
            # compute dtype, as flax adds it
            x = F.conv2d(x, p["kernel"].to(dt).permute(3, 2, 0, 1), padding="same")
            x = torch.relu(x + p["bias"].to(dt)[:, None, None])
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        for i in range(2):
            p = params[f"Dense_{i}"]
            x = x @ p["kernel"].to(dt) + p["bias"].to(dt)
            if i == 0:
                x = torch.relu(x)
        return x.float()


def init_cnn_params(input_shape, channels: Sequence[int], num_classes: int, seed: int, device) -> dict:
    """flax ``Conv`` and ``Dense`` defaults from a seeded
    ``torch.Generator``: kernels ``lecun_normal`` (fan-in ``kh·kw·in`` for
    a conv), biases zero (fp32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w, c = input_shape
    params: dict = {}
    for i, ch in enumerate(channels):
        kernel = _lecun_normal((9 * c, ch), gen, device).reshape(3, 3, c, ch)
        params[f"Conv_{i}"] = {"kernel": kernel, "bias": torch.zeros(ch, device=device)}
        c, h, w = ch, h // 2, w // 2
    for i, (fan_in, fan_out) in enumerate([(h * w * c, 128), (128, num_classes)]):
        params[f"Dense_{i}"] = {
            "kernel": _lecun_normal((fan_in, fan_out), gen, device),
            "bias": torch.zeros(fan_out, device=device),
        }
    return params


def cnn(seed: int = 0, num_classes: int = 10, input_shape=(28, 28, 1), device=None) -> TorchModel:
    """The CNN bound to fresh parameters on ``device`` (``None`` = cuda)."""
    module = CNN(num_classes=num_classes)
    params = init_cnn_params(input_shape, module.channels, num_classes, seed, resolve_device(device))
    return TorchModel(module, params, tuple(input_shape), num_classes)


# ---- ResNet and ViT (BASELINE configs 2-4) ----

#: flax's ``GroupNorm`` and ``LayerNorm`` epsilon (PyTorch's default is 1e-5)
NORM_EPS = 1e-6


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"``: the output has ``ceil(size / stride)``
    positions and the padding falls short before: ``(total // 2, total -
    total // 2)``. At stride 2 on an even input a 3x3 kernel pads (0, 1)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int, dt, bias=None) -> torch.Tensor:
    """flax ``Conv(padding="SAME")`` on an NCHW ``x`` in compute dtype
    ``dt``: the HWIO kernel permuted to OIHW at use; an uneven SAME
    padding is applied by ``F.pad`` before an unpadded convolution
    (``F.conv2d``'s padding is symmetric)."""
    kh, kw = kernel.shape[:2]
    (top, bottom), (left, right) = _same_pads(x.shape[-2], kh, stride), _same_pads(x.shape[-1], kw, stride)
    w = kernel.to(dt).permute(3, 2, 0, 1)
    if top == bottom and left == right:
        y = F.conv2d(x, w, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)
    return y if bias is None else y + bias.to(dt)[:, None, None]


def _group_norm(x: torch.Tensor, p: dict, groups: int = 8) -> torch.Tensor:
    """flax ``GroupNorm(num_groups=8)`` on NCHW ``x``: statistics and the
    affine in fp32 (eps 1e-6), the result rounded once to ``x``'s dtype.
    PyTorch's statistics do not cancel where flax's fast-variance form
    E[x²] − E[x]² does (a mean far above the spread); elsewhere the two
    agree to fp32 rounding."""
    return F.group_norm(x.float(), groups, p["scale"], p["bias"], NORM_EPS).to(x.dtype)


def _layer_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: fp32 statistics, eps 1e-6, an
    fp32 result."""
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"], p["bias"], NORM_EPS)


def _dense(x: torch.Tensor, p: dict, dt) -> torch.Tensor:
    return x @ p["kernel"].to(dt) + p["bias"].to(dt)


class ResNet(nn.Module):
    """ResNet for CIFAR-scale inputs with GroupNorm, flax's ``ResNet``:
    a 3x3 stem of 64 channels, ``stage_sizes`` blocks a stage (basic
    ``ResBlock``s, or ``BottleneckBlock``s of 4x expansion), the first
    block of stages 2-4 at stride 2 with a 1x1 projection of the residual
    wherever its shape changes, a spatial mean and one Dense.
    ``forward(params, x)`` → fp32 logits.

    GroupNorm, as in the JAX package: FedAvg of BatchNorm's running
    statistics is ill-defined across non-IID shards, and every parameter
    stays a plain weight that FedAvg averages."""

    def __init__(
        self, stage_sizes: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False,
        num_classes: int = 10, dtype=None,
    ) -> None:
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.bottleneck = bottleneck
        self.num_classes = num_classes
        self.dtype = getattr(torch, Settings.COMPUTE_DTYPE) if dtype is None else dtype

    def blocks(self) -> list[tuple[str, int, int]]:
        """``(name, filters, stride)`` of every block, named as flax names
        them (``ResBlock_{k}`` or ``BottleneckBlock_{k}``, counted across
        stages)."""
        kind = "BottleneckBlock" if self.bottleneck else "ResBlock"
        out = []
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                out.append((f"{kind}_{len(out)}", 64 * 2**i, 2 if i > 0 and j == 0 else 1))
        return out

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = torch.relu(_group_norm(_conv(x, params["Conv_0"]["kernel"], 1, dt), params["GroupNorm_0"]))
        block = self._bottleneck_block if self.bottleneck else self._res_block
        for name, _, stride in self.blocks():
            x = block(params[name], x, stride)
        x = x.mean(dim=(2, 3))
        return _dense(x, params["Dense_0"], dt).float()

    def _res_block(self, p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(_group_norm(_conv(x, p["Conv_0"]["kernel"], stride, dt), p["GroupNorm_0"]))
        y = _group_norm(_conv(y, p["Conv_1"]["kernel"], 1, dt), p["GroupNorm_1"])
        if x.shape != y.shape:
            x = _group_norm(_conv(x, p["Conv_2"]["kernel"], stride, dt), p["GroupNorm_2"])
        return torch.relu(y + x)

    def _bottleneck_block(self, p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(_group_norm(_conv(x, p["Conv_0"]["kernel"], 1, dt), p["GroupNorm_0"]))
        y = torch.relu(_group_norm(_conv(y, p["Conv_1"]["kernel"], stride, dt), p["GroupNorm_1"]))
        y = _group_norm(_conv(y, p["Conv_2"]["kernel"], 1, dt), p["GroupNorm_2"])
        if x.shape != y.shape:
            x = _group_norm(_conv(x, p["Conv_3"]["kernel"], stride, dt), p["GroupNorm_3"])
        return torch.relu(y + x)


def _norm_params(c: int, device) -> dict:
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def _conv_kernel(k: int, c_in: int, c_out: int, gen, device) -> torch.Tensor:
    """flax ``lecun_normal`` for an HWIO kernel (fan-in ``k·k·c_in``)."""
    return _lecun_normal((k * k * c_in, c_out), gen, device).reshape(k, k, c_in, c_out)


def init_resnet_params(module: ResNet, input_shape, seed: int, device) -> dict:
    """flax's initializers from a seeded ``torch.Generator``: conv and
    Dense kernels ``lecun_normal``, GroupNorm scales one and biases zero,
    the Dense bias zero. The projection (``Conv_2``/``GroupNorm_2``, in a
    bottleneck ``Conv_3``/``GroupNorm_3``) exists where the residual's
    shape changes, as flax creates it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {"Conv_0": {"kernel": _conv_kernel(3, input_shape[-1], 64, gen, device)},
              "GroupNorm_0": _norm_params(64, device)}
    c = 64
    for name, f, stride in module.blocks():
        if module.bottleneck:
            out = 4 * f
            convs = [(1, c, f), (3, f, f), (1, f, out)]
        else:
            out = f
            convs = [(3, c, f), (3, f, f)]
        if stride != 1 or c != out:
            convs.append((1, c, out))
        block = {}
        for j, (k, c_in, c_out) in enumerate(convs):
            block[f"Conv_{j}"] = {"kernel": _conv_kernel(k, c_in, c_out, gen, device)}
            block[f"GroupNorm_{j}"] = _norm_params(c_out, device)
        params[name] = block
        c = out
    params["Dense_0"] = {"kernel": _lecun_normal((c, module.num_classes), gen, device),
                         "bias": torch.zeros(module.num_classes, device=device)}
    return params


def _resnet(module: ResNet, seed: int, input_shape, device) -> TorchModel:
    params = init_resnet_params(module, input_shape, seed, resolve_device(device))
    return TorchModel(module, params, tuple(input_shape), module.num_classes)


def resnet18(seed: int = 0, num_classes: int = 10, input_shape=(32, 32, 3), device=None) -> TorchModel:
    """ResNet-18 (11.2M parameters at 10 classes) on ``device`` (``None`` = cuda)."""
    return _resnet(ResNet((2, 2, 2, 2), num_classes=num_classes), seed, input_shape, device)


def resnet50(seed: int = 0, num_classes: int = 100, input_shape=(32, 32, 3), device=None) -> TorchModel:
    """ResNet-50 (bottleneck blocks, 23.7M parameters at 100 classes) on
    ``device`` (``None`` = cuda)."""
    return _resnet(ResNet((3, 4, 6, 3), bottleneck=True, num_classes=num_classes), seed, input_shape, device)


class ViTBlock(nn.Module):
    """Pre-norm encoder block, flax's ``ViTBlock``: LayerNorm (fp32), a
    ``qkv`` Dense, bidirectional attention with fp32 scores and softmax,
    ``proj``; LayerNorm, ``fc1``, tanh GELU, ``fc2``; both residual. The
    attention is plain ``torch.matmul`` (the JAX package's einsum; no
    Pallas kernel there)."""

    def __init__(self, heads: int, mlp_ratio: int = 4, dtype=None) -> None:
        super().__init__()
        self.heads = heads
        self.mlp_ratio = mlp_ratio
        self.dtype = getattr(torch, Settings.COMPUTE_DTYPE) if dtype is None else dtype

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:  # [B, T, D]
        dt = self.dtype
        b, t, d = x.shape
        h = self.heads
        hd = d // h
        y = _layer_norm(x, p["LayerNorm_0"]).to(dt)
        qkv = _dense(y, p["qkv"], dt).reshape(b, t, 3, h, hd)
        q, k, v = (a.transpose(1, 2) for a in qkv.unbind(2))  # [B, H, T, hd]
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        a = torch.softmax(s * hd**-0.5, dim=-1).to(dt)
        o = torch.matmul(a, v).transpose(1, 2).reshape(b, t, d)
        x = x + _dense(o, p["proj"], dt)
        y = _layer_norm(x, p["LayerNorm_1"]).to(dt)
        y = _dense(F.gelu(_dense(y, p["fc1"], dt), approximate="tanh"), p["fc2"], dt)
        return x + y


class ViT(nn.Module):
    """Small vision transformer, flax's ``ViT``: a conv patch embed
    (``patch_embed``), the learned top-level ``pos_embed``, ``depth``
    ``ViTBlock``s (``block_{i}``), a mean over the patches, an fp32
    LayerNorm and an fp32 ``head``. ``forward(params, x)`` → fp32 logits."""

    def __init__(
        self, num_classes: int = 10, patch: int = 4, dim: int = 64, depth: int = 4, heads: int = 4,
        dtype=None,
    ) -> None:
        super().__init__()
        self.num_classes, self.patch, self.dim, self.depth, self.heads = num_classes, patch, dim, depth, heads
        self.dtype = getattr(torch, Settings.COMPUTE_DTYPE) if dtype is None else dtype
        self.block = ViTBlock(heads, dtype=self.dtype)

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        dt = self.dtype
        p = params["patch_embed"]
        x = _conv(x.to(dt).permute(0, 3, 1, 2), p["kernel"], self.patch, dt, p["bias"])
        x = x.flatten(2).transpose(1, 2)  # [B, hh·ww, D], patches in row-major order
        x = x + params["pos_embed"].to(dt)
        for i in range(self.depth):
            x = self.block(params[f"block_{i}"], x)
        x = _layer_norm(x.mean(dim=1), params["LayerNorm_0"])
        head = params["head"]
        return x @ head["kernel"] + head["bias"]


def init_vit_params(module: ViT, input_shape, seed: int, device) -> dict:
    """flax's initializers from a seeded ``torch.Generator``: kernels
    ``lecun_normal`` and biases zero, ``pos_embed`` ``normal(0.02)``,
    LayerNorm scales one and biases zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w, c = input_shape
    d = module.dim
    patches = -(-h // module.patch) * -(-w // module.patch)

    def dense(fan_in: int, fan_out: int) -> dict:
        return {"kernel": _lecun_normal((fan_in, fan_out), gen, device), "bias": torch.zeros(fan_out, device=device)}

    params = {
        "patch_embed": {"kernel": _conv_kernel(module.patch, c, d, gen, device), "bias": torch.zeros(d, device=device)},
        "pos_embed": torch.randn((1, patches, d), generator=gen, device=device) * 0.02,
    }
    for i in range(module.depth):
        params[f"block_{i}"] = {
            "LayerNorm_0": _norm_params(d, device), "qkv": dense(d, 3 * d), "proj": dense(d, d),
            "LayerNorm_1": _norm_params(d, device), "fc1": dense(d, module.block.mlp_ratio * d),
            "fc2": dense(module.block.mlp_ratio * d, d),
        }
    params["LayerNorm_0"] = _norm_params(d, device)
    params["head"] = dense(d, module.num_classes)
    return params


def vit(
    seed: int = 0, num_classes: int = 10, input_shape=(32, 32, 3), patch: int = 4, dim: int = 64,
    depth: int = 4, heads: int = 4, dtype=None, device=None,
) -> TorchModel:
    """The ViT on ``device`` (``None`` = cuda); ``dtype=None`` is
    ``Settings.COMPUTE_DTYPE``."""
    module = ViT(num_classes=num_classes, patch=patch, dim=dim, depth=depth, heads=heads, dtype=dtype)
    params = init_vit_params(module, input_shape, seed, resolve_device(device))
    return TorchModel(module, params, tuple(input_shape), num_classes)
