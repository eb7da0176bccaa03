"""Port parity: the video feature pipeline (``data/video.py``) and its
ResNet-18 (``models/aux_nets.py``), kinpoly_tpu_torch against kinpoly_tpu,
float64 on the CPU: the ResNet-18 on fresh flax parameters with random
BatchNorm statistics (at 64 x 64, where flax's "SAME" pads the stride-2
layers asymmetrically, and at an odd size) and on the trained encoder of
``data_bank/of_encoder.pkl``; each flow function on a seeded uint8 clip of
64 x 64 frames (the pyramid at 3 levels, and the uint8 wrap of a single
level); compute_of_features with the trained encoder; the person boxes,
crops and features."""

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from kinpoly_tpu.data import video as jv
from kinpoly_tpu.models.aux_nets import ResNet18 as JResNet18
from kinpoly_tpu_torch.data import video as tv
from kinpoly_tpu_torch.models import aux_nets, weights

torch.set_num_threads(1)

TOL = 1e-10          # float64 flow and convolutions
NET_TOL = 1e-9       # ResNet-18 outputs, relative to their largest


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol * max(1.0, float(np.abs(a).max())), err


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _random_flax_resnet(out_dim, in_ch, seed):
    """Fresh flax ResNet-18 variables in float64, the BatchNorm scales,
    biases and statistics drawn at random."""
    v = _f64(JResNet18(out_dim=out_dim).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, in_ch))))
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return x
        if "var" in name or "scale" in name:
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0, 0.2, x.shape)

    return jax.tree_util.tree_map_with_path(perturb, v)


def _port_resnet(variables, in_ch, out_dim):
    net = aux_nets.ResNet18(in_ch, out_dim).double()
    net.load_state_dict(weights.resnet18_from_jax(variables))
    return net


@pytest.mark.parametrize("hw", [(64, 64), (37, 50)])
def test_resnet18_random_params(hw):
    v = _random_flax_resnet(24, 2, 0)
    x = np.random.RandomState(1).normal(size=(3,) + hw + (2,))
    want = JResNet18(out_dim=24).apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = _port_resnet(v, 2, 24)(torch.tensor(x))
    _close(want, got, NET_TOL)


def test_same_padding():
    """flax's "SAME": 7x7/2 on 64 pads (2, 3), 3x3/2 (0, 1), 1x1/2 none,
    3x3/1 (1, 1); an odd size 7 at 3x3/2 pads (1, 1)."""
    assert aux_nets.same_pad(64, 7, 2) == (2, 3)
    assert aux_nets.same_pad(32, 3, 2) == (0, 1)
    assert aux_nets.same_pad(16, 1, 2) == (0, 0)
    assert aux_nets.same_pad(16, 3, 1) == (1, 1)
    assert aux_nets.same_pad(7, 3, 2) == (1, 1)


@pytest.fixture(scope="module")
def encoder():
    """of_encoder.pkl read by joblib (JAX side, float64) and by the port's
    encoder (its own reader)."""
    params = _f64(joblib.load(tv.OF_ENCODER)["params"])
    assert len(jax.tree.leaves(params)) == 90
    enc = tv.FlowFeatureEncoder(device="cpu", dtype=torch.float64)
    return params, enc


def test_resnet18_of_encoder(encoder):
    params, enc = encoder
    x = np.random.RandomState(2).normal(0, 2.0, (4, 64, 64, 2))
    want = JResNet18(out_dim=512).apply(params, jnp.asarray(x))
    _close(want, enc(torch.tensor(x)), NET_TOL)


@pytest.fixture(scope="module")
def clip():
    """A seeded uint8 clip (5, 64, 64): smooth blobs drifting a pixel or
    two per frame, plus noise."""
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:64, 0:64]
    frames = []
    for t in range(5):
        img = np.zeros((64, 64))
        for cx, cy, r, a in ((20, 30, 8, 120), (44, 20, 6, 90), (40, 48, 10, 60)):
            img += a * np.exp(-((xx - cx - 1.5 * t) ** 2
                                + (yy - cy - 0.7 * t) ** 2) / (2 * r * r))
        img += rng.uniform(0, 30, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames)


def test_resize_half_and_warp(clip):
    _close(jv._resize_half(clip[0]),
           tv._resize_half(torch.tensor(clip[0]), torch.float64))
    rng = np.random.RandomState(4)
    u, v = rng.normal(0, 3, (2, 64, 64))
    _close(jv._warp(clip[1], u, v),
           tv._warp(torch.tensor(clip[1]), torch.tensor(u), torch.tensor(v)))
    f = clip[1].astype(np.float64)
    _close(jv._warp(f, u, v), tv._warp(torch.tensor(f), torch.tensor(u),
                                       torch.tensor(v)))


@pytest.mark.parametrize("inputs", ["uint8", "float"])
def test_horn_schunck(clip, inputs):
    """On uint8 frames the temporal difference wraps in both packages."""
    a, b = clip[0], clip[1]
    if inputs == "float":
        a, b = a.astype(np.float64), b.astype(np.float64)
    _close(jv.horn_schunck(a, b, iters=8),
           tv.horn_schunck(torch.tensor(a), torch.tensor(b), iters=8,
                           dtype=torch.float64))


def test_pyramid_flow_batched(clip):
    """levels=3 on uint8 frames, every consecutive pair at once in the
    port, one pair at a time in the reference."""
    want = np.stack([jv.pyramid_flow(clip[i], clip[i + 1], 3)
                     for i in range(len(clip) - 1)])
    got = tv.pyramid_flow(torch.tensor(clip[:-1]), torch.tensor(clip[1:]), 3,
                          dtype=torch.float64)
    _close(want, got)
    assert float(np.abs(want).max()) > 0.1


def test_compute_of_features(clip, encoder):
    """The whole entry point with the trained encoder (the JAX side's in
    float64 through the same flax module)."""
    params, enc = encoder
    apply = jax.jit(lambda x: JResNet18(out_dim=512).apply(params, x))
    want = jv.compute_of_features(clip, lambda f: np.asarray(apply(jnp.asarray(f))))
    got = tv.compute_of_features(clip, enc)
    assert got.shape == (len(clip), 512)
    _close(want, got, NET_TOL)


def test_person_features():
    """Box smoothing and crops against the reference, then the extractor
    at a small crop size with fresh flax parameters."""
    rng = np.random.RandomState(5)
    T = 6
    frames = rng.randint(0, 256, (T, 48, 40, 3)).astype(np.uint8)
    boxes = np.stack([20 + rng.normal(0, 2, T), 24 + rng.normal(0, 2, T),
                      14 + rng.normal(0, 1, T), 20 + rng.normal(0, 1, T)], -1)
    _close(jv.smooth_bboxes(boxes, 5), tv.smooth_bboxes(boxes, 5), 0)
    for f, b in ((frames[0], boxes[0]), (frames[1, ..., 0], boxes[1])):
        _close(jv.crop_person(f, b, 32), tv.crop_person(f, b, 32), 0)
    v = _random_flax_resnet(16, 3, 6)
    jx = jv.PersonFeatureExtractor(feature_dim=16, params=v, crop_size=32)
    tx = tv.PersonFeatureExtractor(feature_dim=16, params=v, crop_size=32,
                                   device="cpu", dtype=torch.float64)
    _close(jx(frames, boxes, batch=4), tx(frames, boxes, batch=4), NET_TOL)


def test_encoders_default_to_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.FlowFeatureEncoder()
