"""The paper's FedMNIST MLP (Appendix A.1), the port of ``repro.models.small``.

Parameters keep the reference's layout and names, a dict of
``{"fc0", "fc1", "fc2"}`` each ``{"w": (in, out), "b": (out,)}`` applied as
``x @ w + b``, so the reference's weights carry across unchanged
(:func:`repro_torch.convert.params_from_jax`).  ``forward`` also takes
*stacked* parameters with a leading client axis and inputs ``(s, B, ...)``,
and then runs one ``torch.bmm`` per layer for the whole cohort; each
client's loss depends only on its own slice, so the gradient of the summed
loss is each client's own gradient.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import prng

# float32 matrix products stay in full float32 (no TF32), as on the reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
        params = {}
        for i in range(3):
            k1 = prng.split(keys[i], 2)[0]
            scale = float(np.sqrt(np.float32(2.0 / d[i])))
            params[f"fc{i}"] = {
                "w": scale * prng.normal(k1, (d[i], d[i + 1]), device=device),
                "b": torch.zeros(d[i + 1], dtype=torch.float32,
                                 device=device)}
        return params

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        stacked = params["fc0"]["w"].dim() == 3
        x = x.reshape(x.shape[:2] + (-1,) if stacked else (x.shape[0], -1))
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
