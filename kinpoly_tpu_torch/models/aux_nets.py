"""The auxiliary model zoo (port of ``kinpoly_tpu/models/aux_nets.py``;
reference ``kin_poly/models/`` and ``uhc/khrylib/models/``): the visual
encoders (ResNet-18, MobileNet, SimpleCNN), the temporal baselines (TCN,
ERDNet, CMLP), the GAIL discriminator, the three video nets, the SpaceNet
VAE and the categorical policy head. The ResNet-18 is the flow encoder of
the use_of path (``data/video.py``); the rest are off the main path.

Inputs and outputs are channels-last at the interface, as the flax
modules': images (N, H, W, C), voxels (N, D, H, W, C), sequences (B, T, D).
The convolutions run channels-first inside. flax pads ``"SAME"``
asymmetrically where the total is odd (the extra row at the end: a 7x7/2
convolution of 64 pixels pads (2, 3), a 3x3/2 one (0, 1)), which torch's
symmetric ``padding=`` cannot express, so every convolution and the
max-pool pad explicitly (``same_pad``), the max-pool with -inf.

BatchNorm follows flax's: ``train=False`` normalises with the running
statistics; ``train=True`` with the batch's mean and biased variance
(flax's E[x^2] - E[x]^2, clipped at 0), and updates the running statistics
in place with momentum 0.99 (torch's 0.01) from that biased variance,
where torch's own BatchNorm keeps the unbiased one. eps 1e-5 in both
modes.

Layer names mirror the flax trees; ``models/weights.py`` has a
``<net>_from_jax`` for each net. Fresh parameters follow flax's
initialisation (``init_flax_``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kinpoly_tpu_torch.models import nets
from kinpoly_tpu_torch.models.nets import MLP, _linear
from kinpoly_tpu_torch.models.rnn import RNN

BN_EPS = 1e-5        # flax BatchNorm's default epsilon
BN_MOMENTUM = 0.99   # flax BatchNorm's default momentum
_CONV = {2: F.conv2d, 3: F.conv3d}


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (before, after) of one spatial axis."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_spec(shape, k: int, s: int) -> list[int]:
    """F.pad's list (last axis first) for "SAME" over the given axes."""
    out = []
    for n in reversed(shape):
        out += list(same_pad(n, k, s))
    return out


class Conv(nn.Module):
    """A k x k (x k) convolution over `dims` spatial axes with stride s and
    "SAME" padding; bias-free unless asked, grouped with `groups` (the
    depthwise convolution's groups = channels)."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int = 1,
                 groups: int = 1, bias: bool = False, dims: int = 2):
        super().__init__()
        self.k, self.s, self.groups, self.dims = k, s, groups, dims
        self.weight = nn.Parameter(torch.empty((c_out, c_in // groups) + (k,) * dims))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, _pad_spec(x.shape[-self.dims:], self.k, self.s))
        return _CONV[self.dims](x, self.weight, self.bias, stride=self.s,
                                groups=self.groups)


class ConvTranspose(nn.Module):
    """flax's ``ConvTranspose`` (kernel k, stride s, "SAME": the output is s
    times the input) over three spatial axes. flax's transposed convolution
    correlates the s-dilated input, padded (a, k + s - 2 - a), with its
    kernel; torch's pads the dilated input (k - 1, k - 1) and correlates
    with the flipped kernel. So ``weight`` holds flax's kernel flipped on
    every spatial axis (``weights.space_net_from_jax``), torch runs with no
    padding, and the output is cropped to flax's window: for k = 3, s = 2
    the last position of each axis goes."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int):
        super().__init__()
        self.s = s
        self.weight = nn.Parameter(torch.empty(c_in, c_out, k, k, k))
        self.bias = nn.Parameter(torch.empty(c_out))
        pad_len = k + s - 2          # flax's (a, pad_len - a) around the dilated input
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        self.start = k - 1 - pad_a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose3d(x, self.weight, self.bias, stride=self.s)
        for ax, n in enumerate(x.shape[-3:]):
            y = y.narrow(y.dim() - 3 + ax, self.start, n * self.s)
        return y


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis (1), flax's semantics (module
    docstring)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False, eps=BN_EPS)
        dims = [0] + list(range(2, x.dim()))
        # flax's "fast variance", E[x^2] - E[x]^2 clipped at 0
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            self.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class ResBlock(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.conv0 = Conv(c_in, features, 3, stride)
        self.bn0 = BatchNorm(features)
        self.conv1 = Conv(features, features, 3)
        self.bn1 = BatchNorm(features)
        self.shortcut = (Conv(c_in, features, 1, stride)
                         if c_in != features or stride != 1 else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(self.bn0(self.conv0(x), train))
        y = self.bn1(self.conv1(y), train)
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
        self.fc = _linear(c, out_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(N, H, W, in_ch) -> (N, out_dim)."""
        x = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2)), train))
        x = F.max_pool2d(F.pad(x, _pad_spec(x.shape[-2:], 3, 2),
                               value=float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        return self.fc(x.mean(dim=(-2, -1)))


class DWBlock(nn.Module):
    """Depthwise 3x3 (stride s) and pointwise 1x1 convolutions, each with
    BatchNorm and ReLU."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.conv_dw = Conv(c_in, c_in, 3, stride, groups=c_in)
        self.bn0 = BatchNorm(c_in)
        self.conv_pw = Conv(c_in, features, 1)
        self.bn1 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Channels-first (N, C, H, W) inside the encoder."""
        x = torch.relu(self.bn0(self.conv_dw(x), train))
        return torch.relu(self.bn1(self.conv_pw(x), train))


# (features, stride) of MobileNet's six depthwise-separable blocks
DW_BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2))


class MobileNet(nn.Module):
    """Depthwise-separable encoder (kin_poly/models/mobile_net.py): a 3x3/2
    stem to 32 channels, six DWBlocks, the spatial mean, a linear head."""

    def __init__(self, in_ch: int, out_dim: int = 128):
        super().__init__()
        self.conv = Conv(in_ch, 32, 3, 2)
        self.bn = BatchNorm(32)
        c, blocks = 32, []
        for feats, stride in DW_BLOCKS:
            blocks.append(DWBlock(c, feats, stride))
            c = feats
        self.blocks = nn.ModuleList(blocks)
        self.fc = _linear(c, out_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(N, H, W, in_ch) -> (N, out_dim)."""
        x = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2)), train))
        for block in self.blocks:
            x = block(x, train)
        return self.fc(x.mean(dim=(-2, -1)))


class SimpleCNN(nn.Module):
    """Three 3x3/2 convolutions with bias and ReLU (32, 64, 128 channels),
    the spatial mean, a linear head (kin_poly/models/simple_cnn.py)."""

    def __init__(self, in_ch: int, out_dim: int = 128):
        super().__init__()
        chans = (in_ch, 32, 64, 128)
        self.convs = nn.ModuleList(Conv(a, b, 3, 2, bias=True)
                                   for a, b in zip(chans, chans[1:]))
        self.fc = _linear(chans[-1], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = torch.relu(conv(x))
        return self.fc(x.mean(dim=(-2, -1)))


class TCN(nn.Module):
    """Dilated causal convolutions over (B, T, D) (kin_poly/models/tcn.py):
    layer i pads (k - 1) 2^i steps on the left and runs a VALID convolution
    of dilation 2^i; then a linear head per step."""

    def __init__(self, in_dim: int, channels: Sequence[int] = (64, 64, 64),
                 kernel: int = 3, out_dim: int = 64):
        super().__init__()
        self.kernel = kernel
        dims = (in_dim,) + tuple(channels)
        self.convs = nn.ModuleList(
            nn.utils.skip_init(nn.Conv1d, a, b, kernel, dilation=2 ** i)
            for i, (a, b) in enumerate(zip(dims, dims[1:])))
        self.fc = _linear(dims[-1], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = torch.relu(conv(F.pad(x, ((self.kernel - 1) * conv.dilation[0], 0))))
        return self.fc(x.transpose(1, 2))


class ERDNet(nn.Module):
    """Encoder-recurrent-decoder baseline (kin_poly/models/erd_net.py): MLP,
    LSTM, MLP, linear head."""

    def __init__(self, in_dim: int, state_dim: int, hidden: int = 256):
        super().__init__()
        self.enc = MLP(in_dim, (hidden,))
        self.rnn = RNN(hidden, hidden, "lstm")
        self.dec = MLP(hidden, (hidden,))
        self.fc = _linear(hidden, state_dim)

    def forward(self, x: torch.Tensor, time_axis: int = 1) -> torch.Tensor:
        return self.fc(self.dec(self.rnn(self.enc(x), time_axis)))


class CMLP(nn.Module):
    """Causal MLP over windows (kin_poly/models/causal_mlp.py): each step
    sees itself and the `window` - 1 steps before it (the time axis padded
    with zeros on the left), concatenated."""

    def __init__(self, in_dim: int, out_dim: int, window: int = 5,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.window = window
        self.mlp = MLP(window * in_dim, hidden)
        self.fc = _linear(tuple(hidden)[-1], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        pads = F.pad(x, (0, 0, self.window - 1, 0))
        win = pads.unfold(1, self.window, 1).transpose(-1, -2)   # (B, T, W, D)
        return self.fc(self.mlp(win.reshape(B, T, self.window * D)))


class Discriminator(nn.Module):
    """GAIL discriminator (uhc/khrylib/models/discriminator.py): a tanh MLP
    and a scalar head."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.mlp = MLP(in_dim, hidden, "tanh")
        self.fc = _linear(tuple(hidden)[-1], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.mlp(x))[..., 0]


class VideoRegNet(nn.Module):
    """Video -> pose regression (kin_poly/models/video_reg_net.py):
    ResNet-18 features per frame, a bidirectional GRU, an MLP head."""

    def __init__(self, in_ch: int, out_dim: int, cnn_fdim: int = 128,
                 hidden: int = 256):
        super().__init__()
        self.cnn_fdim = cnn_fdim
        self.cnn = ResNet18(in_ch, cnn_fdim)
        self.rnn = RNN(cnn_fdim, hidden, "gru", bi_dir=True)
        self.mlp = MLP(2 * hidden, (hidden,))
        self.fc = _linear(hidden, out_dim)

    def forward(self, frames: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, T, out_dim)."""
        B, T = frames.shape[:2]
        feats = self.cnn(frames.reshape((B * T,) + frames.shape[2:]), train)
        h = self.rnn(feats.reshape(B, T, self.cnn_fdim))
        return self.fc(self.mlp(h))


class VideoStateNet(nn.Module):
    """Video features -> per-frame latent state (kin_poly/models/
    video_state_net.py): a bidirectional GRU and a linear head."""

    def __init__(self, in_dim: int, state_dim: int = 128, hidden: int = 256):
        super().__init__()
        self.rnn = RNN(in_dim, hidden, "gru", bi_dir=True)
        self.fc = _linear(2 * hidden, state_dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.fc(self.rnn(feats))


class VideoForecastNet(nn.Module):
    """Latent forecasting head (kin_poly/models/video_forecast_net.py): a GRU
    encodes the features; a decoder GRU cell, fed a zero 1-wide input,
    runs `horizon` steps from the encoder's last state; a linear head per
    step."""

    def __init__(self, in_dim: int, state_dim: int = 128, hidden: int = 256,
                 horizon: int = 30):
        super().__init__()
        self.horizon = horizon
        self.rnn = RNN(in_dim, hidden, "gru")
        self.dec = RNN(1, hidden, "gru")
        self.fc = _linear(hidden, state_dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, in_dim) -> (B, horizon, state_dim)."""
        last = self.rnn(feats)[:, -1]
        zeros = last.new_zeros(last.shape[0], self.horizon, 1)
        _, outs = self.dec.scan(last, zeros)
        return self.fc(outs)


class SpaceNet(nn.Module):
    """3D-convolutional VAE over voxel occupancy (kin_poly/models/
    space_net.py): three 3x3x3/2 convolutions (16, 32, 64 channels), mean
    and log-variance heads, a linear decoder input, three transposed
    convolutions back to one channel. `voxel_num` (the grid's edge) fixes
    the flattened width, which flax infers at its first call."""

    def __init__(self, latent_dim: int = 64, voxel_num: int = 16, in_ch: int = 1):
        super().__init__()
        chans = (in_ch, 16, 32, 64)
        self.convs = nn.ModuleList(Conv(a, b, 3, 2, bias=True, dims=3)
                                   for a, b in zip(chans, chans[1:]))
        n = voxel_num
        for _ in range(3):
            n = -(-n // 2)
        self.code_shape = (n, n, n, chans[-1])
        flat = math.prod(self.code_shape)
        self.mu = _linear(flat, latent_dim)
        self.logvar = _linear(flat, latent_dim)
        self.dec_in = _linear(latent_dim, flat)
        self.deconvs = nn.ModuleList(ConvTranspose(a, b, 3, 2)
                                     for a, b in ((64, 32), (32, 16), (16, 1)))

    def forward(self, voxels: torch.Tensor,
                generator: torch.Generator | None = None):
        """voxels (B, V, V, V, C) -> (reconstruction (B, V, V, V, 1), mu,
        logvar). z = mu without a generator, else mu + exp(logvar / 2)
        times a standard normal drawn from it."""
        x = voxels.permute(0, 4, 1, 2, 3)
        for conv in self.convs:
            x = torch.relu(conv(x))
        flat = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        mu, logvar = self.mu(flat), self.logvar(flat)
        z = mu
        if generator is not None:
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                              device=mu.device)
            z = mu + torch.exp(0.5 * logvar) * eps
        y = self.dec_in(z).reshape((-1,) + self.code_shape).permute(0, 4, 1, 2, 3)
        for i, deconv in enumerate(self.deconvs):
            y = deconv(y)
            if i < len(self.deconvs) - 1:
                y = torch.relu(y)
        return y.permute(0, 2, 3, 4, 1), mu, logvar


class PolicyDiscrete(nn.Module):
    """Categorical policy head (uhc/khrylib/rl/core/policy_disc.py): a ReLU
    MLP to `action_num` logits."""

    def __init__(self, in_dim: int, action_num: int,
                 hidden: Sequence[int] = (512, 256)):
        super().__init__()
        self.mlp = MLP(in_dim, hidden)
        self.fc = _linear(tuple(hidden)[-1], action_num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.mlp(x))


def categorical_sample(generator: torch.Generator,
                       logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of logits (..., K) by the Gumbel-max trick, as
    ``jax.random.categorical``: equal to JAX's in distribution, not draw
    for draw."""
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def categorical_log_prob(action: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action[..., None].long())[..., 0]


@torch.no_grad()
def init_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh parameters as flax initialises them: lecun-normal convolution
    kernels (fan_in = input channels per group x kernel volume; a
    transposed convolution's fan_in is its input channels x kernel
    volume), zero convolution biases, BatchNorm scale 1, bias 0 and
    statistics (0, 1), then ``nets.init_flax_`` for the linear layers and
    the recurrent cells. Draws from `generator`, on the parameters'
    device."""
    for m in module.modules():
        if isinstance(m, (Conv, nn.Conv1d)):
            nets._lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ConvTranspose):
            nets._lecun_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(),
                                generator)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return nets.init_flax_(module, generator)
