"""Functional NN primitives over a parameter tree, in PyTorch.

Counterpart of ``sam2_video_tpu/ops/common.py``:

- Parameters live in a :class:`ParamTree`, an ``nn.Module`` whose
  ``state_dict`` keys are the flattened JAX paths
  (``image_encoder.trunk.blocks.0.attn.qkv.weight``), which are also the
  torch SAM2 checkpoint names. Functions index it like the JAX dicts
  (``p["attn"]["qkv"]["weight"]``).
- Layouts are torch-native: Linear ``[out, in]``, Conv2d OIHW,
  ConvTranspose2d IOHW. Activations stay NHWC at every public function, as
  in the JAX package, so the two compare like with like.
- Mixed precision follows the JAX dtype walk: weights are kept in float32
  and cast to the activation dtype at use; normalisation statistics are
  always float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """Nested parameters addressed like a dict; the module path of every
    leaf is its flattened JAX path. Parameters are frozen (eval port).

    A key that starts with ``_`` holds an entry derived from the parameters
    (``models/sam2.py`` ``prepare``, as in the JAX package): it is kept as
    given, is not a parameter, and stays out of ``state_dict`` and ``.to``.
    """

    def __init__(self, tree: dict):
        super().__init__()
        self.derived = {}
        for k, v in tree.items():
            if k.startswith("_"):
                self.derived[k] = v
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._modules:
            return self._modules[key]
        if key in self.derived:
            return self.derived[key]
        return self._parameters[key]

    def __contains__(self, key: str) -> bool:
        return (key in self._modules or key in self._parameters
                or key in self.derived)

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def __len__(self) -> int:
        return len(self._parameters) + len(self._modules) + len(self.derived)

    def tree(self) -> dict:
        """Nested dict of the same tensors (and derived entries)."""
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        out.update(self.derived)
        return out


def requires_grad(tree) -> bool:
    """Whether any parameter of a ParamTree or nested dict requires grad
    (derived entries, keys starting with ``_``, are not parameters)."""
    if isinstance(tree, ParamTree):
        return any(t.requires_grad for t in tree.parameters())
    return any(requires_grad(v) if isinstance(v, dict) else
               (isinstance(v, torch.Tensor) and v.requires_grad)
               for k, v in tree.items() if not k.startswith("_"))


def forward_only(name: str, why: str, p, *tensors) -> None:
    """Raise when a forward-only kernel would have to carry a gradient:
    grad mode on and a parameter of ``p`` or an input requiring grad."""
    if torch.is_grad_enabled() and (
            requires_grad(p) or any(t.requires_grad for t in tensors)):
        raise NotImplementedError(f"{name} is a forward-only kernel: {why}")


# ---------------------------------------------------------------------------
# Initialisers (torch defaults, drawn from an explicit generator)
# ---------------------------------------------------------------------------


def _kaiming_uniform(gen: torch.Generator, shape, fan_in: int):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def trunc_normal(gen: torch.Generator, shape, std: float = 0.02):
    """trunc_normal_(std=std), truncated at two standard deviations."""
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2.0 * std,
                                 b=2.0 * std, generator=gen)


def linear_init(gen, in_dim: int, out_dim: int, bias: bool = True):
    p = {"weight": _kaiming_uniform(gen, (out_dim, in_dim), in_dim)}
    if bias:
        p["bias"] = _kaiming_uniform(gen, (out_dim,), in_dim)
    return p


def layer_norm_init(dim: int):
    return {"weight": torch.ones(dim), "bias": torch.zeros(dim)}


def conv2d_init(gen, in_ch: int, out_ch: int, kernel_size: int,
                bias: bool = True, groups: int = 1):
    fan_in = in_ch // groups * kernel_size * kernel_size
    p = {"weight": _kaiming_uniform(
        gen, (out_ch, in_ch // groups, kernel_size, kernel_size), fan_in)}
    if bias:
        p["bias"] = _kaiming_uniform(gen, (out_ch,), fan_in)
    return p


def conv_transpose2d_init(gen, in_ch: int, out_ch: int, kernel_size: int,
                          bias: bool = True):
    fan_in = in_ch * kernel_size * kernel_size
    p = {"weight": _kaiming_uniform(
        gen, (in_ch, out_ch, kernel_size, kernel_size), fan_in)}
    if bias:
        p["bias"] = _kaiming_uniform(gen, (out_ch,), fan_in)
    return p


def mlp_init(gen, in_dim: int, hidden_dim: int, out_dim: int,
             num_layers: int):
    dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
    return {"layers": {str(i): linear_init(gen, dims[i], dims[i + 1])
                       for i in range(num_layers)}}


def embedding_init(gen, num: int, dim: int):
    return {"weight": torch.randn((num, dim), generator=gen)}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def add_compute_casts(tree: dict, dtype: torch.dtype) -> None:
    """Give every product (a ``weight`` of two or more axes: linear, conv;
    LayerNorm weights are 1-D) its weight and bias in ``dtype`` under
    ``_weight``/``_bias``, made once instead of cast at every call."""
    w = tree.get("weight")
    if isinstance(w, torch.Tensor) and w.ndim >= 2:
        tree["_weight"] = w.to(dtype)
        if "bias" in tree:
            tree["_bias"] = tree["bias"].to(dtype)
    for v in list(tree.values()):
        if isinstance(v, dict):
            add_compute_casts(v, dtype)


def _in(p, key: str, dtype: torch.dtype) -> torch.Tensor:
    """``p[key]`` in ``dtype``: the copy ``add_compute_casts`` made, else
    a cast here."""
    made = p.get("_" + key)
    if made is not None and made.dtype == dtype:
        return made
    return p[key].to(dtype)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ weight[out, in]^T (+ bias, added in x's dtype)."""
    y = F.linear(x, _in(p, "weight", x.dtype))
    if "bias" in p:
        y = y + _in(p, "bias", x.dtype)
    return y


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32, one cast back."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def layer_norm_2d(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm2d on NHWC: the channel axis is last, eps 1e-6."""
    return layer_norm(p, x, eps=eps)


def conv2d(p, x: torch.Tensor, stride: int = 1, padding=0,
           groups: int = 1) -> torch.Tensor:
    """x [N, H, W, C] with an OIHW kernel -> [N, H', W', O].

    ``padding`` is an int or ((top, bottom), (left, right)). A 1x1 conv at
    stride 1 is the product it is, over the channel axis."""
    w = _in(p, "weight", x.dtype)
    b = _in(p, "bias", x.dtype) if "bias" in p else None
    if w.shape[-2:] == (1, 1) and stride == 1 and padding == 0 \
            and groups == 1:
        y = F.linear(x, w[:, :, 0, 0])
        return y if b is None else y + b
    xc = x.permute(0, 3, 1, 2)
    if isinstance(padding, int):
        pad = padding
    else:
        (pt, pb), (pl, pr) = padding
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = 0
    y = F.conv2d(xc, w, None, stride, pad, groups=groups)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b


def conv_transpose2d(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    """ConvTranspose2d with kernel_size == stride (non-overlapping): one
    product ``out[n, i*s+k, j*s+l, o] = sum_c x[n,i,j,c] w[c,o,k,l]``."""
    w = _in(p, "weight", x.dtype)                  # [in, out, s, s]
    s = w.shape[-1]
    if s != stride or w.shape[-2] != stride:
        raise ValueError("conv_transpose2d needs kernel_size == stride")
    n, h, wd, _ = x.shape
    y = torch.einsum("nhwc,cokl->nhkwlo", x, w)
    y = y.reshape(n, h * s, wd * s, w.shape[1])
    if "bias" in p:
        y = y + _in(p, "bias", x.dtype)
    return y


def max_pool2d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """x [N, H, W, C]; VALID pooling (torch MaxPool2d, ceil_mode=False)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default."""
    return F.gelu(x)


def mlp(p, x: torch.Tensor, activation: str = "relu",
        sigmoid_output: bool = False) -> torch.Tensor:
    layers = p["layers"]
    n = len(layers)
    act = {"relu": F.relu, "gelu": gelu}[activation]
    for i in range(n):
        x = linear(layers[str(i)], x)
        if i < n - 1:
            x = act(x)
    if sigmoid_output:
        x = torch.sigmoid(x)
    return x
