"""The egocentric video feature pipeline (port of
``kinpoly_tpu/data/video.py``): Horn-Schunck pyramid optical flow between
consecutive grayscale frames, encoded per frame into the (T, 512) ``of``
features of the use_of configuration by a ResNet-18
(``models/aux_nets.py``) with the weights of ``data_bank/of_encoder.pkl``;
and the person-crop feature extractor (box smoothing, square crop,
ResNet-18).

The flow functions take tensors of any leading batch shape (..., H, W) on
the caller's device and compute in the floating dtype `dtype` (float32 on
the card, float64 in the CPU parity tests). An integer frame stays integer
where the reference's numpy code keeps it so: at the finest pyramid level
until the warp makes it float, and the temporal difference of two integer
frames is taken in their own type (uint8 wraps, as numpy's does). The
bilinear warp gathers with clipped indices as the reference does
(``grid_sample``'s edge handling differs). ``smooth_bboxes`` and
``crop_person`` are host-side numpy, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.data.banks import read_bank
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.models.aux_nets import ResNet18, init_flax_

# the flow encoder trained on synthetic egomotion flow, in the repo
OF_ENCODER = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data_bank", "of_encoder.pkl")

# the Horn-Schunck neighbourhood average
_HS_KERNEL = ((1 / 12, 1 / 6, 1 / 12), (1 / 6, 0.0, 1 / 6),
              (1 / 12, 1 / 6, 1 / 12))


def _resize_half(img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(..., H, W) -> (..., H // 2, W // 2): the mean of each 2 x 2 block,
    in `dtype`."""
    h, w = img.shape[-2:]
    x = img[..., : h // 2 * 2, : w // 2 * 2].to(dtype)
    return x.reshape(x.shape[:-2] + (h // 2, 2, w // 2, 2)).mean(dim=(-3, -1))


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``np.gradient`` along `dim`: central differences inside, one-sided
    at the two edges."""
    n = x.shape[dim]
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2
    return torch.cat([x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1), inner,
                      x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)], dim)


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of `img` (..., H, W) at (x + u, y + v), the sample
    point clipped to the image: a gather of the four neighbours."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    yy = torch.arange(h, device=u.device, dtype=u.dtype)[:, None]
    xx = torch.arange(w, device=u.device, dtype=u.dtype)[None, :]
    xs = torch.clamp(xx + u, 0, w - 1)
    ys = torch.clamp(yy + v, 0, h - 1)
    x0, y0 = xs.long(), ys.long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    fx, fy = xs - x0, ys - y0
    flat = img.reshape(lead + (h * w,))

    def at(yi, xi):
        return torch.gather(flat, -1, (yi * w + xi).reshape(lead + (h * w,))
                            ).reshape(lead + (h, w))

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
            + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)


def _avg(x: torch.Tensor) -> torch.Tensor:
    """The Horn-Schunck 3 x 3 weighted average, edge-replicated."""
    lead = x.shape[:-2]
    k = torch.tensor(_HS_KERNEL, dtype=x.dtype, device=x.device)[None, None]
    p = F.pad(x.reshape((-1, 1) + x.shape[-2:]), (1, 1, 1, 1), mode="replicate")
    return F.conv2d(p, k).reshape(lead + x.shape[-2:])


def horn_schunck(im1: torch.Tensor, im2: torch.Tensor, alpha: float = 15.0,
                 iters: int = 32, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Single-level Horn-Schunck flow between grayscale images (..., H, W):
    (..., H, W, 2) in `dtype`."""
    a = im1.to(dtype)
    Ix, Iy = _gradient(a, -1), _gradient(a, -2)
    It = (im2 - im1).to(dtype)
    u = torch.zeros_like(a)
    v = torch.zeros_like(a)
    den = alpha ** 2 + Ix ** 2 + Iy ** 2
    for _ in range(iters):
        ubar, vbar = _avg(u), _avg(v)
        num = Ix * ubar + Iy * vbar + It
        u = ubar - Ix * num / den
        v = vbar - Iy * num / den
    return torch.stack([u, v], dim=-1)


def pyramid_flow(im1: torch.Tensor, im2: torch.Tensor, levels: int = 3,
                 dtype: torch.dtype = torch.float32, **kw) -> torch.Tensor:
    """Coarse-to-fine optical flow (..., H, W) -> (..., H, W, 2): the
    coarsest level's flow, upsampled (x2) to warp the next level's first
    image, plus that level's flow, down to full size."""
    pyr1, pyr2 = [im1], [im2]
    for _ in range(levels - 1):
        pyr1.append(_resize_half(pyr1[-1], dtype))
        pyr2.append(_resize_half(pyr2[-1], dtype))
    flow = None
    for lvl in reversed(range(levels)):
        a, b = pyr1[lvl], pyr2[lvl]
        if flow is None:
            flow = horn_schunck(a, b, dtype=dtype, **kw)
        else:
            h, w = a.shape[-2:]
            up = flow.repeat_interleave(2, -3).repeat_interleave(2, -2)
            up = up[..., :h, :w, :] * 2.0
            warped = _warp(a, up[..., 0], up[..., 1])
            flow = up + horn_schunck(warped, b, dtype=dtype, **kw)
    return flow


class FlowFeatureEncoder:
    """Flow fields -> per-frame features through the ResNet-18 (2 input
    channels) on `device` (CUDA unless given) in `dtype`: with `params`
    (flax variables) those, else at feature_dim 512 the trained weights of
    ``OF_ENCODER`` (read by the port's bank reader), else fresh weights
    (seed 0)."""

    def __init__(self, feature_dim: int = 512, params: dict | None = None,
                 device=None, dtype: torch.dtype = torch.float32):
        self.device, self.dtype = resolve_device(device), dtype
        self.net = ResNet18(2, feature_dim).to(dtype=dtype)
        if params is None and feature_dim == 512 and os.path.exists(OF_ENCODER):
            params = read_bank(OF_ENCODER)["params"]
        if params is not None:
            self.net.load_state_dict(weights.resnet18_from_jax(params))
        else:
            init_flax_(self.net, torch.Generator().manual_seed(0))
        self.net.to(self.device)

    @torch.no_grad()
    def __call__(self, flows: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 2) flow fields -> (N, feature_dim)."""
        return self.net(torch.as_tensor(flows, device=self.device).to(self.dtype))


@torch.no_grad()
def compute_of_features(frames, encoder: FlowFeatureEncoder,
                        levels: int = 3) -> torch.Tensor:
    """(T, H, W) grayscale video (uint8 or float, numpy or tensor) ->
    (T, D) flow features on the encoder's device: the flow between each
    pair of consecutive frames, all pairs at once, the first duplicated
    for frame 0 as in the reference."""
    f = torch.as_tensor(frames, device=encoder.device)
    flows = pyramid_flow(f[:-1], f[1:], levels, dtype=encoder.dtype)
    return encoder(torch.cat([flows[:1], flows]))


# ---------------------------------------------------------------------------
# person-crop features (the reference's SPIN feature extractor pipeline:
# smoothed person box -> square crop -> backbone -> per-frame vector)
# ---------------------------------------------------------------------------


def smooth_bboxes(boxes: np.ndarray, window: int = 11) -> np.ndarray:
    """Temporal median of per-frame person boxes (T, 4) [cx, cy, w, h] over
    a centred `window`, float64."""
    T = len(boxes)
    out = np.empty_like(boxes, dtype=np.float64)
    r = window // 2
    for t in range(T):
        out[t] = np.median(boxes[max(0, t - r):min(T, t + r + 1)], axis=0)
    return out


def crop_person(frame: np.ndarray, box, out_size: int = 224,
                scale: float = 1.2) -> np.ndarray:
    """Square crop around [cx, cy, w, h] with margin `scale`, bilinearly
    resized to (out_size, out_size[, C]) and mapped to [-1, 1], float32."""
    cx, cy, w, h = box
    s = max(w, h) * scale
    x0, y0 = cx - s / 2, cy - s / 2
    ys = np.clip(np.linspace(y0, y0 + s, out_size), 0, frame.shape[0] - 1)
    xs = np.clip(np.linspace(x0, x0 + s, out_size), 0, frame.shape[1] - 1)
    yi0, xi0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    yi1 = np.minimum(yi0 + 1, frame.shape[0] - 1)
    xi1 = np.minimum(xi0 + 1, frame.shape[1] - 1)
    fy = (ys - yi0)[:, None, None] if frame.ndim == 3 else (ys - yi0)[:, None]
    fx = (xs - xi0)[None, :, None] if frame.ndim == 3 else (xs - xi0)[None, :]
    f = frame.astype(np.float64)
    top = f[yi0][:, xi0] * (1 - fx) + f[yi0][:, xi1] * fx
    bot = f[yi1][:, xi0] * (1 - fx) + f[yi1][:, xi1] * fx
    return ((top * (1 - fy) + bot * fy) / 127.5 - 1.0).astype(np.float32)


class PersonFeatureExtractor:
    """Per-frame person features: smoothed boxes, square crops, the
    ResNet-18 (3 input channels; `params` as flax variables, else fresh
    weights, seed 0) on `device` (CUDA unless given) in `dtype`."""

    def __init__(self, feature_dim: int = 2048, params: dict | None = None,
                 crop_size: int = 224, device=None,
                 dtype: torch.dtype = torch.float32):
        self.crop_size = crop_size
        self.device, self.dtype = resolve_device(device), dtype
        self.net = ResNet18(3, feature_dim).to(dtype=dtype)
        if params is not None:
            self.net.load_state_dict(weights.resnet18_from_jax(params))
        else:
            init_flax_(self.net, torch.Generator().manual_seed(0))
        self.net.to(self.device)

    @torch.no_grad()
    def __call__(self, frames: np.ndarray, boxes: np.ndarray,
                 batch: int = 32) -> torch.Tensor:
        """frames (T, H, W, 3) uint8, boxes (T, 4) [cx, cy, w, h] ->
        (T, feature_dim)."""
        boxes = smooth_bboxes(np.asarray(boxes, np.float64))
        crops = torch.as_tensor(np.stack([
            crop_person(f, b, self.crop_size) for f, b in zip(frames, boxes)]),
            device=self.device).to(self.dtype)
        return torch.cat([self.net(crops[i:i + batch])
                          for i in range(0, len(crops), batch)])
