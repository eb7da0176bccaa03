"""UHC coverage evaluation of a trained checkpoint on the port (port of
``scripts/eval_uhc.py``).

    python -m kinpoly_tpu_torch.scripts.eval_uhc --iter 13000 \\
        --data data_bank/clips24.pkl [--seeds 4] [--metrics] [--device cpu]

Loads ``<out>/motion_im/<cfg>/models/iter_<iter>.p`` of ``--cfg`` (a named
config or a UHC YAML path, named after its basename), builds the UHC env on
the synthetic SMPL humanoid over the takes of ``--data`` (a
``data_bank/*.pkl`` expert bank: a dict of takes with ``qpos`` (T, 76)),
and runs one env per take with deterministic actions for ``--max-steps``
control steps (default: the longest take + 2). Prints one line per take
and the coverage; ``--seeds N`` adds the coverage band over N runs with
sampled actions; ``--metrics`` tracks every take with mean actions for
its length - 1 steps without reset, cut at its first termination, and
prints the pose metrics of the tracked against the expert qpos per take
and their MEAN row.

Without ``--data`` the takes are ``--clips`` seeded clips of ``--frames``
frames (24 and 120), made as the JAX benchmark makes its clip: the standing
pose plus a seeded cumulative uniform walk of the joint angles (+-0.005 rad
per frame). With ``--data``, ``--clips`` and ``--frames`` cut the bank to
its first takes and frames.
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
from kinpoly_tpu_torch.data.banks import load_takes
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.metrics.pose_metrics import evaluate_pair
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.rl import running_norm as rn
from kinpoly_tpu_torch.rl.agent_uhc import UHCAgent
from kinpoly_tpu_torch.utils.logger import create_logger


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


def get_takes(data: str | None, n_clips: int | None = None,
              n_frames: int | None = None, seed: int = 0) -> dict[str, np.ndarray]:
    """{name: qpos (T, 76) float32}: the first `n_clips` takes of the bank
    at `data`, each cut to its first `n_frames` frames (None: all), or
    without a bank `n_clips` seeded clips of `n_frames` frames (None: 24
    and 120)."""
    if data:
        takes = list(load_takes(data).items())[:n_clips]
        return {k: q[:n_frames] for k, q in takes}
    return {f"clip_{i}": c for i, c in enumerate(
        make_clips(synthetic_spec(), n_clips or 24, n_frames or 120, seed))}


def build_agent(iter_: int, takes: dict, device, dtype=torch.float32,
                out_root: str = "results", cfg_name: str = "uhc") -> UHCAgent:
    """The UHC agent of config `cfg_name` (a name or a YAML path) with
    checkpoint `iter_` loaded, on an evaluation env over `takes`. The
    physics takes the default control parameters, as the JAX script's
    (implicit residual forces, no limit)."""
    device = resolve_device(device)
    cfg = UHCConfig.load(cfg_name)
    spec = synthetic_spec()
    model = eng.build_model(spec, uhc_control_params(spec), device=device,
                            dtype=dtype)
    bank = make_bank(spec, model, list(takes.values()))
    agent = UHCAgent(HumanoidImEnv(model, cfg.env_config(), bank, mode="test"),
                     cfg)
    agent.load_checkpoint(os.path.join(cfg.model_dir(out_root),
                                       f"iter_{iter_:04d}.p"))
    return agent


@torch.no_grad()
def track(agent: UHCAgent, n_steps: int):
    """`n_steps` control steps of one env per clip from a deterministic
    reset with mean actions, no env frozen or reset: (qpos (n_steps, n, 76),
    done (n_steps, n)) on the host."""
    env = agent.env
    state, obs = env.reset(torch.arange(env.n_clips, device=env.model.device))
    qpos, dones = [], []
    for _ in range(n_steps):
        mean, _ = agent.policy(rn.apply(agent.norm, obs))
        state, obs, _, done, _ = env.step(state, mean)
        qpos.append(state.sim.qpos)
        dones.append(done)
    return torch.stack(qpos).cpu(), torch.stack(dones).cpu().numpy()


def pose_metric_rows(agent: UHCAgent, takes: dict, n_steps: int) -> dict:
    """{take: {metric: float}} of `track` against each take's expert qpos,
    cut at the take's first termination (and at its length - 1)."""
    model = agent.env.model
    qpos_seq, dones = track(agent, n_steps)
    rows = {}
    for i, (name, gt) in enumerate(takes.items()):
        T = gt.shape[0]
        d = np.nonzero(dones[:, i])[0]
        end = min(int(d[0]) + 1 if len(d) else T - 1, T - 1, n_steps)
        gt_t = torch.as_tensor(gt[1:end + 1], dtype=model.dtype,
                               device=model.device)
        m = evaluate_pair(model, qpos_seq[:end, i].to(model.device), gt_t)
        rows[name] = {k: float(v) for k, v in m.items()}
    return rows


def mean_row(rows: dict) -> dict:
    first = next(iter(rows.values()))
    return {k: float(np.mean([r[k] for r in rows.values()])) for k in first}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default="uhc",
                   help="a named config (uhc, uhc_quatv2) or a UHC YAML path")
    p.add_argument("--iter", type=int, default=13000)
    p.add_argument("--data", default=None,
                   help="expert bank (data_bank/*.pkl); default: seeded clips")
    p.add_argument("--seeds", type=int, default=0,
                   help="N runs with sampled actions for a coverage band")
    p.add_argument("--metrics", action="store_true",
                   help="also print the pose metrics per take and their mean")
    p.add_argument("--clips", type=int, default=None,
                   help="seeded clips (24), or the first takes of --data")
    p.add_argument("--frames", type=int, default=None,
                   help="frames of the seeded clips (120), or the first "
                        "frames of each take of --data")
    p.add_argument("--max-steps", type=int, default=None,
                   help="control steps (default: the longest take + 2)")
    p.add_argument("--seed", type=int, default=0, help="seed of the clips")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="results")
    args = p.parse_args(argv)

    log = create_logger()
    takes = get_takes(args.data, args.clips, args.frames, args.seed)
    t_max = max(t.shape[0] for t in takes.values())
    agent = build_agent(args.iter, takes, args.device, out_root=args.out,
                        cfg_name=args.cfg)
    steps = args.max_steps or t_max + 2
    t0 = time.perf_counter()
    cov, info = agent.eval_coverage(max_steps=steps, stochastic_seeds=args.seeds)
    if agent.env.model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for name, ok, pct in zip(takes, info["succ"], info["percent"]):
        log.info(f"{name}: {'OK' if ok else 'FAIL'}  tracked {pct:.1%}")
    log.info(f"coverage_det {cov:.4f} over {len(info['succ'])} clips, mean "
             f"tracked {float(np.mean(info['percent'])):.1%}, {steps} control "
             f"steps x {1 + args.seeds} runs in {dt:.2f} s on "
             f"{agent.env.model.device}")
    if args.seeds:
        log.info(f"coverage_mean {info['coverage_mean']:.4f} +- "
                 f"{info['coverage_std']:.4f} over {args.seeds} seeds")
    if args.metrics:
        rows = pose_metric_rows(agent, takes, t_max - 1)
        for name, m in rows.items():
            log.info(f"{name}: " + " ".join(f"{k}:{v:.2f}" for k, v in m.items()))
        log.info("MEAN  " + " ".join(f"{k}:{v:.3f}"
                                     for k, v in mean_row(rows).items()))


if __name__ == "__main__":
    main()
