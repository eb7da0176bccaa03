"""The ResNet-18 feature encoder of the video pipeline (port of
``ResBlock`` and ``ResNet18`` of ``kinpoly_tpu/models/aux_nets.py``), in
evaluation mode: every BatchNorm normalises with its running statistics
(flax ``use_running_average=True``, eps 1e-5).

Inputs and outputs are channels-last at the interface, (N, H, W, C) ->
(N, out_dim), as the flax module's; the convolutions run channels-first
inside. flax pads ``"SAME"`` asymmetrically where the total is odd (the
extra row and column at the end: a 7x7/2 convolution of 64 pixels pads
(2, 3), a 3x3/2 one (0, 1)), which torch's symmetric ``padding=`` cannot
express, so every convolution and the max-pool pad explicitly
(``same_pad``), the max-pool with -inf. Layer names mirror the flax tree
(``models/weights.resnet18_from_jax``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kinpoly_tpu_torch.models import nets

BN_EPS = 1e-5      # flax BatchNorm's default epsilon


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (before, after) of one spatial axis."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A bias-free k x k convolution with stride s and "SAME" padding."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int = 1):
        super().__init__()
        self.k, self.s = k, s
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = (same_pad(n, self.k, self.s) for n in x.shape[-2:])
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight, stride=self.s)


class BatchNorm(nn.Module):
    """BatchNorm over channels with the running statistics, always."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False, eps=BN_EPS)


class ResBlock(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.conv0 = Conv(c_in, features, 3, stride)
        self.bn0 = BatchNorm(features)
        self.conv1 = Conv(features, features, 3)
        self.bn1 = BatchNorm(features)
        self.shortcut = (Conv(c_in, features, 1, stride)
                         if c_in != features or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(torch.relu(self.bn0(self.conv0(x)))))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return torch.relu(x + y)


# (features, stride) of the eight residual blocks
BLOCKS = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
          (512, 2), (512, 1))


class ResNet18(nn.Module):
    """7x7/2 stem, BatchNorm, ReLU, 3x3/2 max-pool, eight residual blocks,
    the spatial mean and a linear head to `out_dim` features."""

    def __init__(self, in_ch: int, out_dim: int = 128):
        super().__init__()
        self.conv = Conv(in_ch, 64, 7, 2)
        self.bn = BatchNorm(64)
        c, blocks = 64, []
        for feats, stride in BLOCKS:
            blocks.append(ResBlock(c, feats, stride))
            c = feats
        self.blocks = nn.ModuleList(blocks)
        self.fc = nets._linear(c, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, in_ch) -> (N, out_dim)."""
        x = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        (t, b), (l, r) = (same_pad(n, 3, 2) for n in x.shape[-2:])
        x = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.fc(x.mean(dim=(-2, -1)))

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "ResNet18":
        """Fresh parameters as flax initialises them: lecun-normal
        convolution kernels (fan_in = in x k x k) and the head's (its bias
        0); BatchNorm scale 1, bias 0, statistics (0, 1)."""
        for m in self.modules():
            if isinstance(m, Conv):
                nets._lecun_normal_(m.weight, m.weight[0].numel(), generator)
        nets.init_flax_(self, generator)
        return self
