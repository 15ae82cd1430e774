"""The paper's small models (Appendix A.1), the port of
``repro.models.small``: the FedMNIST MLP and the FedCIFAR10 CNN.

Parameters keep the reference's layout and names, so the reference's
weights carry across unchanged (:func:`repro_torch.convert.params_from_jax`):
dense layers ``{"w": (in, out), "b": (out,)}`` applied as ``x @ w + b``,
conv layers ``{"w": (5, 5, cin, cout), "b": (cout,)}`` in HWIO.  The HWIO
element order matters beyond the weights themselves: TopK's slot order and
the Q_r uniforms drawn per element follow each leaf's element order.
``forward`` also takes *stacked* parameters with a leading client axis and
inputs ``(s, B, ...)``, and then runs one ``torch.bmm`` per dense layer and
one grouped convolution per conv layer for the whole cohort; each client's
loss depends only on its own slice, so the gradient of the summed loss is
each client's own gradient.  The reference convolves with
``lax.conv_general_dilated`` outside any Pallas kernel, so the port's
convolutions are PyTorch's own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng

# float32 matrix products stay in full float32 (no TF32), as on the reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the CNN's convolutions take deterministic cuDNN algorithms: the same round
# gives the same bits run to run, as the reference's do
torch.backends.cudnn.deterministic = True


def _dense_init(key, n_in, n_out, device):
    """He-normal ``(n_in, n_out)`` weights from ``split(key)[0]`` and zero
    biases, the reference's scheme and float32 scale."""
    k1 = prng.split(key, 2)[0]
    scale = float(np.sqrt(np.float32(2.0 / n_in)))
    return {"w": scale * prng.normal(k1, (n_in, n_out), device=device),
            "b": torch.zeros(n_out, dtype=torch.float32, device=device)}


def _dense(p, x):
    if p["w"].dim() == 3:                       # stacked clients
        return torch.bmm(x, p["w"]) + p["b"].unsqueeze(1)
    return x @ p["w"] + p["b"]


class MLP(nn.Module):
    """784 -> hidden -> hidden -> 10, ReLU (paper's FedMNIST model)."""

    def __init__(self, in_dim: int = 784, hidden: int = 128,
                 n_classes: int = 10):
        super().__init__()
        self.dims = (in_dim, hidden, hidden, n_classes)

    def init(self, key, device="cuda") -> dict:
        """He-normal weights and zero biases from ``key``: the reference's
        scheme, key splits and float32 scale, bit for bit with its init
        on the CPU."""
        keys = prng.split(prng.key_data(key), 3)
        d = self.dims
        return {f"fc{i}": _dense_init(keys[i], d[i], d[i + 1], device)
                for i in range(3)}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        stacked = params["fc0"]["w"].dim() == 3
        x = x.reshape(x.shape[:2] + (-1,) if stacked else (x.shape[0], -1))
        x = torch.relu(_dense(params["fc0"], x))
        x = torch.relu(_dense(params["fc1"], x))
        return _dense(params["fc2"], x)

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return self(params, x)


def _conv_init(key, h, w, cin, cout, device):
    """He-normal HWIO weights ``(h, w, cin, cout)`` drawn from ``key``
    itself (no split, as the reference draws them) and zero biases."""
    scale = float(np.sqrt(np.float32(2.0 / (h * w * cin))))
    return {"w": scale * prng.normal(key, (h, w, cin, cout), device=device),
            "b": torch.zeros(cout, dtype=torch.float32, device=device)}


def _conv(p, x):
    """5x5 VALID convolution of NCHW ``x`` with the HWIO leaf, permuted to
    OIHW here only.  Stacked clients ``(s, h, w, cin, cout)`` run as one
    grouped convolution: ``x`` is ``(B, s*cin, H, W)``, client-major."""
    w = p["w"]
    if w.dim() == 5:
        s, _, _, cin, cout = w.shape
        w = w.permute(0, 4, 3, 1, 2).reshape(s * cout, cin, *w.shape[1:3])
        return F.conv2d(x, w, p["b"].reshape(-1), groups=s)
    return F.conv2d(x, w.permute(3, 2, 0, 1), p["b"])


def _maxpool2(x):
    return F.max_pool2d(x, 2, 2)


class CNN(nn.Module):
    """LeNet-style: conv5x5(6) -> pool -> conv5x5(16) -> pool -> 120-84-C
    (the FedLab CIFAR10 CNN the paper uses).  Inputs are NHWC ``(B, 32,
    32, 3)`` as in the reference, or ``(s, B, 32, 32, 3)`` with stacked
    parameters; the features are flattened in (h, w, c) order before
    ``fc0``, so the reference's ``fc0`` weights carry across unchanged."""

    def __init__(self, in_channels: int = 3, n_classes: int = 10,
                 image_hw: int = 32):
        super().__init__()
        self.cin = in_channels
        self.n_classes = n_classes
        hw = (image_hw - 4) // 2      # after conv1+pool
        hw = (hw - 4) // 2            # after conv2+pool
        self.flat = hw * hw * 16

    def init(self, key, device="cuda") -> dict:
        """The reference's init from ``key``, bit for bit on the CPU."""
        ks = prng.split(prng.key_data(key), 5)
        return {
            "conv0": _conv_init(ks[0], 5, 5, self.cin, 6, device),
            "conv1": _conv_init(ks[1], 5, 5, 6, 16, device),
            "fc0": _dense_init(ks[2], self.flat, 120, device),
            "fc1": _dense_init(ks[3], 120, 84, device),
            "fc2": _dense_init(ks[4], 84, self.n_classes, device),
        }

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        stacked = params["conv0"]["w"].dim() == 5
        if stacked:
            s, b = x.shape[:2]
            # (s, B, H, W, C) -> (B, s*C, H, W): clients are conv groups
            x = x.permute(1, 0, 4, 2, 3).reshape(b, -1, *x.shape[2:4])
        else:
            x = x.permute(0, 3, 1, 2)
        x = _maxpool2(torch.relu(_conv(params["conv0"], x)))
        x = _maxpool2(torch.relu(_conv(params["conv1"], x)))
        if stacked:
            x = x.reshape(b, s, -1, *x.shape[2:]).permute(1, 0, 3, 4, 2)
            x = x.reshape(s, b, -1)
        else:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(_dense(params["fc0"], x))
        x = torch.relu(_dense(params["fc1"], x))
        return _dense(params["fc2"], x)

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return self(params, x)


def cross_entropy_loss(apply_fn):
    """Build ``loss_fn(params, xb, yb)``: mean cross-entropy over the batch
    axis, one value per client for stacked parameters."""

    def loss_fn(params, xb, yb):
        logp = torch.log_softmax(apply_fn(params, xb), dim=-1)
        return -logp.gather(-1, yb.unsqueeze(-1)).squeeze(-1).mean(-1)

    return loss_fn
