"""UHC coverage evaluation of a trained checkpoint on the port.

    python -m kinpoly_tpu_torch.scripts.eval_uhc --iter 13000 --clips 24 \\
        --frames 120 --max-steps 60 --device cuda

Loads ``results/motion_im/uhc/models/iter_<iter>.p``, builds the UHC env on
the synthetic SMPL humanoid, and runs one env per clip with deterministic
actions. The clips are made from ``--seed`` as the JAX benchmark makes its
clip: the standing pose plus a seeded cumulative uniform walk of the joint
angles (+-0.005 rad per frame). Prints one line per clip and a summary.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import standing_pose, synthetic_spec
from kinpoly_tpu_torch.config.defaults import UHCConfig, uhc_control_params
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.rl.agent_uhc import UHCAgent


def make_clips(spec, n_clips: int, n_frames: int, seed: int) -> list[np.ndarray]:
    """Seeded target clips (each (n_frames, 76), float32)."""
    q0 = standing_pose(spec)[0].astype(np.float32)
    rng = np.random.RandomState(seed)
    clips = []
    for _ in range(n_clips):
        seq = np.repeat(q0[None], n_frames, axis=0)
        seq[:, 7:] += np.cumsum(rng.uniform(-0.005, 0.005, (n_frames, 69)),
                                axis=0).astype(np.float32)
        clips.append(seq)
    return clips


def build_agent(iter_: int, n_clips: int, n_frames: int, seed: int, device,
                dtype=torch.float32, out_root: str = "results") -> UHCAgent:
    """The UHC agent with checkpoint `iter_` loaded, on an env of
    `n_clips` seeded clips."""
    device = resolve_device(device)
    cfg = UHCConfig()
    spec = synthetic_spec()
    model = eng.build_model(spec, uhc_control_params(spec), device=device,
                            dtype=dtype)
    bank = make_bank(spec, model, make_clips(spec, n_clips, n_frames, seed))
    agent = UHCAgent(HumanoidImEnv(model, cfg.env_config(), bank), cfg)
    agent.load_checkpoint(os.path.join(cfg.model_dir(out_root),
                                       f"iter_{iter_:04d}.p"))
    return agent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iter", type=int, default=13000)
    p.add_argument("--clips", type=int, default=24)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--max-steps", type=int, default=None,
                   help="control steps (default: frames + 2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="results")
    args = p.parse_args(argv)

    agent = build_agent(args.iter, args.clips, args.frames, args.seed,
                        args.device, out_root=args.out)
    t0 = time.perf_counter()
    cov, info = agent.eval_coverage(max_steps=args.max_steps or args.frames + 2)
    if agent.env.model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i, (ok, pct) in enumerate(zip(info["succ"], info["percent"])):
        print(f"clip {i}: {'OK' if ok else 'FAIL'}  tracked {pct:.1%}")
    steps = args.max_steps or args.frames + 2
    print(f"coverage_det {cov:.4f} over {len(info['succ'])} clips, mean "
          f"tracked {float(np.mean(info['percent'])):.1%}, {steps} control "
          f"steps in {dt:.2f} s on {agent.env.model.device}")


if __name__ == "__main__":
    main()
