"""AMASS take datasets (port of ``kinpoly_tpu/data/amass_dataset.py``): the
reference's data-loader family as one host-side class.

- per-take windows of t_min..t_max frames (``sample_seq``), drawn with the
  caller's ``np.random.RandomState``, so one seed gives the same windows in
  both packages
- adaptive hard-sequence sampling: per-take success history -> sampling
  probability proportional to exp(-ewma(success) / temp)
- ``to_bank``: every take through ``data.expert.from_qpos`` on the device,
  stacked into one ExpertClip bank for the batched UHC env
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import spec_tensors
from kinpoly_tpu_torch.data import expert as exlib


@dataclass
class AMASSDataset:
    takes: dict                      # {name: {"qpos": (T, 76), ...}}
    t_min: int = 15
    t_max: int = 300
    sampling_temp: float = 2.0
    sampling_freq: float = 0.75      # ewma factor on success history
    has_obj: bool = False

    def __post_init__(self):
        self.keys = sorted(self.takes.keys())
        self.freq_dict = {k: [] for k in self.keys}

    # -- adaptive sampling --------------------------------------------------

    def _ewma(self, xs):
        if not xs:
            return None
        avg = xs[0]
        for x in xs[1:]:
            avg = 0.05 * x + 0.95 * avg
        return avg

    def sampling_probs(self) -> np.ndarray:
        """exp(-ewma(success)/temp), uniform for unseen takes."""
        scores = []
        for k in self.keys:
            hist = [h[0] if isinstance(h, (list, tuple)) else h
                    for h in self.freq_dict[k]]
            e = self._ewma(hist)
            scores.append(0.0 if e is None else e)
        p = np.exp(-np.asarray(scores) / self.sampling_temp)
        return p / p.sum()

    def record_result(self, key_or_idx, success_fraction: float, start: int = 0):
        k = key_or_idx if isinstance(key_or_idx, str) else self.keys[key_or_idx]
        self.freq_dict[k].append((success_fraction, start))

    # -- sampling -----------------------------------------------------------

    def sample_seq(self, rng: np.random.RandomState, full_sample: bool = False):
        """One window dict (the reference worker entry point)."""
        idx = rng.choice(len(self.keys), p=self.sampling_probs())
        k = self.keys[idx]
        take = self.takes[k]
        T = take["qpos"].shape[0]
        if full_sample or T <= self.t_min:
            start, ln = 0, T
        else:
            ln = rng.randint(self.t_min, min(self.t_max, T) + 1)
            start = rng.randint(0, T - ln + 1)
        out = {kk: v[start:start + ln] for kk, v in take.items()
               if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == T}
        out["seq_name"] = k
        out["start"] = start
        return out

    def get_seq_by_ind(self, ind: int, full_sample: bool = True):
        k = self.keys[ind]
        take = self.takes[k]
        out = {kk: v for kk, v in take.items()}
        out["seq_name"] = k
        return out

    def iter_seq(self):
        for i in range(len(self.keys)):
            yield self.get_seq_by_ind(i)

    # -- device bank --------------------------------------------------------

    @torch.no_grad()
    def to_bank(self, spec, dt: float, dtype: torch.dtype = torch.float32,
                pad_to: int | None = None, device=None) -> exlib.ExpertClip:
        """All takes, in key order, padded to the longest (or pad_to) by
        repeating their last frame -> a stacked ExpertClip bank."""
        dev = resolve_device(device)
        st = spec_tensors(spec, dtype, dev)
        t_max = pad_to or max(self.takes[k]["qpos"].shape[0] for k in self.keys)
        clips = [exlib.from_qpos(
            spec, st, torch.as_tensor(np.asarray(self.takes[k]["qpos"]),
                                      dtype=dtype, device=dev),
            dt=dt, pad_to=t_max) for k in self.keys]
        return exlib.stack_bank(clips)
