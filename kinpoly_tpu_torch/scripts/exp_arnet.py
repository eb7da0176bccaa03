"""Supervised training of the kinematic ARNet alone, no physics in the
loop (port of ``scripts/exp_arnet.py``).

    python -m kinpoly_tpu_torch.scripts.exp_arnet --data data_bank/ar_train_56.pkl \\
        --out DIR [--epochs N] [--device cpu]
    python -m kinpoly_tpu_torch.scripts.exp_arnet --data ... --out DIR --test --iter N

Training: TrajARNet (not as a policy) on batches of min(batch_size, 64)
windows, the full-AR loss with scheduled sampling and the config's
observation noise, plain Adam at the config's lr (no clip). A curriculum
over epochs: window length fr_num = 80 + 10 min(epoch // 100, 7) (80 to
150), gt_rate = max(0.3 (1 - epoch / 1000), 0). Saves
``arnet_iter_<epoch>.p`` ({params, epoch}, flax layout) under
``<out>/statear/<cfg>/models/`` every save_model_interval epochs.
``--test`` loads ``arnet_iter_<iter>.p`` and logs each take's pose
metrics of the open-loop rollout against the ground truth, and their
mean. The body has no objects, as the JAX script's MJCF. Without
``--data``, one seeded standing take.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import synthetic_spec
from kinpoly_tpu_torch.config.defaults import KinPolyConfig, uhc_control_params
from kinpoly_tpu_torch.data import statear
from kinpoly_tpu_torch.metrics import pose_metrics
from kinpoly_tpu_torch.models import nets, traj_ar, weights
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.rl.optim import AdamChain
from kinpoly_tpu_torch.scripts.train_ar_policy import get_takes
from kinpoly_tpu_torch.utils.logger import create_logger


def main(argv=None, cfg: KinPolyConfig | None = None):
    """The script; `cfg` replaces the named config (small nets in tests).
    Returns the net, and the metric rows with ``--test``, else the
    epochs' losses."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default="kin_poly")
    p.add_argument("--data", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--test", action="store_true")
    p.add_argument("--iter", type=int, default=0)
    p.add_argument("--out", default="results")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = cfg or KinPolyConfig.named(args.cfg)
    dtype = torch.float32
    log = create_logger(os.path.join(cfg.out_dir(args.out), "log_arnet.txt"))
    spec = synthetic_spec(with_objects=False)
    # the physics model holds the spec's tensors, and the floor contacts
    # the penetration metric reads
    model = eng.build_model(spec, uhc_control_params(spec), device=device,
                            dtype=dtype)
    takes = get_takes(spec, args.data)
    tcfg = cfg.traj_ar_config()
    net = traj_ar.TrajARNet(spec, model.st, tcfg, as_policy=False)
    nets.init_flax_(net, torch.Generator().manual_seed(cfg.seed))
    net.to(device=device, dtype=dtype)
    model_dir = cfg.model_dir(args.out)
    ckpt = os.path.join(model_dir, "arnet_iter_%04d.p")

    if args.test:
        blob = weights.read_checkpoint(ckpt % args.iter)
        net.load_state_dict(weights.trajar_from_jax(blob["params"]))
        dataset = statear.StateARDataset(takes, fr_num=cfg.fr_num)
        rows = []
        for i in range(dataset.n_takes):
            batch = statear.clip_tensors(dataset.whole_take(i), dtype, device)
            with torch.no_grad():
                pred = net(batch)["qpos"][0]
            m = pose_metrics.evaluate_pair(model, pred, batch.qpos[0])
            rows.append({k: float(v) for k, v in m.items()})
            log.info(f"take {i}: " + " ".join(f"{k}:{v:.3f}"
                                              for k, v in rows[-1].items()))
        agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        log.info("MEAN  " + " ".join(f"{k}:{v:.3f}" for k, v in agg.items()))
        return net, rows

    epochs = args.epochs or cfg.num_epoch
    opt = AdamChain(net.parameters(), cfg.lr)
    np_rng = np.random.RandomState(cfg.seed)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    save_every = cfg.policy_specs.get("save_model_interval", 50)
    losses = []
    t0 = time.perf_counter()
    for ep in range(args.iter, epochs):
        fr_num = 80 + 10 * min(ep // 100, 7)
        gt_rate = max(0.3 * (1 - ep / 1000), 0.0)
        dataset = statear.StateARDataset(takes, fr_num=fr_num)
        batch = statear.clip_tensors(
            dataset.get_batch(np_rng, min(cfg.batch_size, 64)), dtype, device)
        loss, _ = traj_ar.compute_loss(
            tcfg, net(batch, gt_rate, gen, train=True), batch)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if ep % 10 == 0:
            log.info(f"epoch {ep} fr {fr_num} gt {gt_rate:.2f} "
                     f"loss {float(loss.detach()):.4f}")
        if (ep + 1) % save_every == 0:
            os.makedirs(model_dir, exist_ok=True)
            with open(ckpt % (ep + 1), "wb") as f:
                pickle.dump({"params": weights.trajar_to_jax(net.state_dict()),
                             "epoch": ep + 1}, f)
    losses = [float(x) for x in torch.stack(losses).cpu()] if losses else []
    if losses:
        wall = time.perf_counter() - t0
        peak = (f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                f" GiB" if device.type == "cuda" else "")
        log.info(f"{len(losses)} epochs in {wall:.2f} s "
                 f"({wall / len(losses):.3f} s per epoch) on {device}{peak}")
    return net, losses


if __name__ == "__main__":
    main()
