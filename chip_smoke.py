#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kinpoly_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. device   needs a CUDA device; prints the card's name and power limit
  2. build    compiles the CUDA kernels (one nvcc call, sm_90a)
  3. kernels  builds the inputs of every kernel from one real substep of
              2048 envs in each solver configuration (LTDL, dense), runs
              each kernel's wrapper and its plain PyTorch version on them
              and on the JAX kernel tests' kind of input, checks the error
              against the JAX tests' tolerances, and times kernel, plain
              version, bound and the nearest PyTorch call; K2 and K3 also
              at the objects slice's shapes (R = 49, 79; C = 72, 108);
              K5 (FK, and FK with the dof frames) on seeded poses at 1024
              and 2048 envs, bitwise against the plain code, timed graph-replayed
              and through its wrapper. K5 runs wherever FK runs on the
              card without a gradient, so the exact launch counts of the
              phases below are of the solver kernels K1-K4c
              (solver_launches); K5's are in each kernel's
              launches_by_path
  4. slice    loads the trained UHC checkpoint iter_13000.p and evaluates
              it for 60 control steps on the 24 takes of 150 frames of the
              real bank data_bank/clips24.pkl (read by the port's bank
              reader; one env per take) through the kernels, with the
              launch counters set to 0 just before and read just after;
              every state must be finite; then tracks the takes for 60
              steps with mean actions and prints the mean pose metrics of
              the tracked frames, every one finite
  5. parity   one control step of 4 envs on the card (float32, kernels)
              against the plain path on the CPU (float64)
  6. quatv2   one env step of 8 envs on seeded clips under the uhc_quatv2
              config, card against CPU as in 5, and its reward (quat_v2)
              and reward components (clips24's first frames sink into the
              synthetic humanoid's floor, where float32 and float64 part
              ways within one step)
  7. train    UHC training at uhc.yml's widths and 1024 envs, depth cut to
              8 control steps, on clips24 with the hard start states of
              data_bank/hard_states_getup.pkl (reactive_v 2): 2 iterations
              of train_epoch (rollout, norm, GAE, PPO) through the LTDL
              kernels, launches counted as in 4, the metrics stream written
              to a temporary directory and read back (one line per
              iteration); losses, rewards and states finite, the policy
              moved, and a saved checkpoint reloads to bit-identical
              outputs; prints the LTDL kernel ms per control step (launches
              x ms at 2048 envs, summed over K1-K3)
  8. dense    one iteration of the same training on 24 seeded clips with
              the dense Cholesky configuration (kernel K4a), launches
              counted; then one control step of 4 envs on the card against
              the CPU float64 plain dense path; prints the dense kernel ms
              per control step (launches x ms at 2048 envs, summed over K4a
              and K3)
  9. states   gen_states: one round of 64 envs x 8 control steps of the
              trained policy on clips24 into a temporary bank, read back
              through the bank reader
 10. ar       the AR evaluation path (eval_ar_policy): the kinematic policy
              iter_0800.p with iter_13000.p as the controller on the 12
              takes of data_bank/wild_takes_r5.pkl, five movable objects,
              contact plan, compaction (16, 8); builds the context (the
              open-loop AR rollout over the longest take, 188 frames), then
              60 control steps of the 12 envs with launch counters set to
              0 just before and read just after (exactly 30 ltdl_factor,
              15 ltdl_solve[R=1], 15 ltdl_solve[R=49] and 15 pgs_solve per
              step); humanoid and object states finite; the pose metrics
              and success of each take finite; prints ms per control step
              and the LTDL kernel ms per AR control step; then one AR env
              step of a seeded take with the box touching the right hand,
              card float32 against the CPU float64 plain path (state,
              objects, reward and its six components), and the same on the
              first 4 wild takes, reported
 11. ar-train AR training at kin_poly.yml's full widths on the 56 takes of
              data_bank/ar_train_56.pkl with iter_13000.p as the
              controller: (a) a fresh warm start (train_init) of 3
              init-state and 2 full-AR steps at batch 256, losses finite
              and the policy moved; (b) iter_0800.p copied to a temporary
              directory and trained on by train_ar_policy --iter 800
              --skip-init --joint-controller for 2 composite epochs of 64
              envs, the rollout cut from 156 to 16 control steps, launch
              counters set to 0 just before and read just after (exactly
              30/15/15[R=49]/15 per rollout control step); every metric
              finite, ppo_grad_norm and ratio_dev above 0, bc_nan_frac 0,
              the controller moved, the final checkpoint read back equal;
              (c) 3 epochs of exp_arnet, losses finite; (d) one recorded
              trajectory (16 envs x 16 steps) through the step-BC loss,
              card float32 against CPU float64: loss within 1e-3 relative
              (gated), the gradient's relative L2 error gated at 1e-2;
              prints seconds per epoch, rollout ms per control step, PPO,
              BC and controller update ms, ms per warm-start step and peak
              memory
 12. use_of   the use_of configuration (policy_v 2: the residual head
              ActionDeltaNet on the AR rollout's pose; the optical-flow
              features in the context and the observation) at use_of.yml's
              widths: (a) eval_ar_policy's path with the tracked warm start
              results_r4/.../use_of/models/iter_0000.p and iter_13000.p as
              the controller on the 12 takes of
              data_bank/wild_takes_r5_of.pkl, 60 control steps, launch
              counters set to 0 just before and read just after (exactly
              30/15/15[R=49]/15 per step), humanoid, object state and
              rewards finite; prints ms per control step, coverage and the
              MEAN row; (b) one AR env step of 4 seeded push takes (seeded
              flow features) with the box on the right hand, card float32
              against CPU float64 (gated as in 10); (c) train_ar_policy
              --cfg use_of --iter 0 --force-init on a copy of iter_0000.p
              and data_bank/action_takes_of.pkl: a warm start of 3
              init-state and 2 full-AR steps at batch 256, then 2
              composite epochs of 64 envs, the rollout cut from 125 to 16
              control steps, launches counted as in (a); every metric
              finite, ppo_grad_norm and ratio_dev above 0, bc_nan_frac 0,
              the final checkpoint holds {"arnet", "delta"} and reads back
              equal; (d) compute_of_features (Horn-Schunck pyramid flow,
              3 levels, and the ResNet-18 encoder of
              data_bank/of_encoder.pkl) on a seeded uint8 clip of 64 x 64
              frames, card float32 against the CPU float64 port within
              1e-3; prints ms per frame
 13. uhc-modes the UHC controller's remaining engine modes: (a) train_uhc
              --cfg on a YAML written to a temporary directory (uhc.yml's
              values from the port's copy, with explicit residual forces on
              every body with torques, meta-PD and local_rfc_explicit with
              its w_cp/k_cp): 2 iterations at 1024 envs, the rollout cut to
              8 control steps, on clips24, a 315-wide policy, launches
              exactly 30/15/15/15 per control step, losses, rewards and
              states finite, the policy moved, the checkpoint reloads
              bit-identical; (b) one control step of 4 envs with explicit
              residual forces and meta-PD, card float32 against CPU float64;
              (c) the contacts-off control step, LTDL (launches exactly 30
              ltdl_factor and 30 ltdl_solve[R=1], no pgs_solve) and dense
              (30 chol_solve_only[R=1]), each card against CPU, the
              movable objects' free fall card against CPU, and host ms per
              control step at 1024 envs with contacts and without; (d)
              eval_pose_all on phase 10's records written to a temporary
              directory as eval_ar_policy writes them: its mean row equals
              phase 10's within 1e-6
 14. data     the data path (no solver kernel on it; K5 under its FK): (a) ground_legs and ground_arms on the first 4 takes
              of clips24, the grid search's batched FK card f32 against
              CPU f64: the delta picked must agree on every frame whose
              grid margin (|min z - clearance|, and for a frame no delta
              grounds the gap between its two best deltas) exceeds 1e-4,
              near ties counted and printed; ms per take; (b)
              process_amass_dir on 6 seeded AMASS npz sequences of 4-8 s
              at 120 Hz in a temporary directory, with flip_augment: the
              same takes kept as on the CPU, qpos within 1e-4 of CPU f64,
              the bank read back by read_bank and stacked by
              AMASSDataset.to_bank on the card; ms per take; export_global_mjcf
              of the synthetic humanoid read back by parse_humanoid (tree,
              offsets and ranges recovered; ms); (c) view_motion from
              --bank data_bank/wild_takes_r5.pkl --take a push take and from
              --result on one of phase 10's records: each HTML's payload
              parsed, its joints (rounded to 4 decimals) at most one
              rounding step from the CPU's; ms per file;
              (d) the three fine_tune rewards on 1024 seeded envs, card
              f32 against CPU f64 within 1e-5
 15. zoo      the rest of anim, the model zoo, TRPO and A2C (no solver
              kernel on it, the counters are read and stay 0; K5 under the
              occupancy's FK): (a) lbs of
              synthetic_model at SMPL's 6890 vertices on 150 seeded frames,
              vertices and joints card f32 within 1e-4 m of CPU f64; ms per
              frame; (b) fit_qpos, 300 Adam steps from standing_pose on the
              FK targets of a 150-frame seeded take (tests/test_retarget.py's
              perturbation, lr and smoothness weight): mean joint error under
              3 cm, qpos finite; s per take; (c) body_occupancy at voxel_num
              16, every body of a standing pose against each of the five
              synthetic objects: card voxels equal the CPU's off the voxels
              within 1e-5 of a geom face, which are counted; (d) every zoo
              net at its default widths (the image encoders on 8 frames of
              64 x 64, VideoRegNet on 2 x 16 frames, SpaceNet on 16^3
              voxels, the sequence nets on (4, 32, 128)) with flax's
              initialisation, card f32 within 1e-3 of CPU f64 relative to
              the output's scale, also one train=True BatchNorm pass and its
              statistics; the moments of SpaceNet's sampled z and
              categorical_sample's frequencies; ms per forward; (e) one
              trpo_update and one a2c_update of a PolicyGaussian and Value at
              uhc.yml's (512, 256) on 8192 seeded samples: TRPO accepted,
              the surrogate improved, its new parameters within 1e-3 of CPU
              f64; A2C's losses and gradients within 1e-3 relative (its new
              parameters' difference reported); ms per update
 16. dp       data parallelism (parallel/dryrun.py), spawned ranks on the
              one card (gloo over CUDA tensors; NCCL refuses two ranks on
              one card), the gloo ranks started once for (c), (a) and (b):
              (c) pmean_grads_ on seeded float32 gradients of a (512, 256)
              value net in each rank against the ranks' mean within 1e-6
              relative, a None gradient kept; (a) the data-parallel UHC
              step (rollout, the JAX step's norm merge, GAE, one value and
              one policy step with averaged gradients) at uhc.yml's
              widths on clips24, 2
              ranks x 512 envs (phase 7's 1024 split), 8 control steps, 2
              steps, launches counted in each rank (exactly 30/15/15/15
              per control step), the norm counting both ranks' samples,
              policy and value bitwise equal across ranks after each step,
              the policy moved, all finite; (b) the AR update with the
              group: train_ar_policy's agent from iter_0800.p with
              iter_13000.p and the joint controller on ar_train_56.pkl, 2
              ranks x 32 envs (kin_poly.yml's 64), 8 control steps (cut
              from 156), 2 steps on a context replicated from rank 0
              (exactly 30/15/15[R=49]/15 per control step and rank),
              policy, value and controller bitwise equal across ranks, the
              controller moved, metrics finite, bc_nan_frac 0; (d) one UHC
              step of 512 envs in a one-rank NCCL group through the same
              code, started after (b); prints per rank s per step,
              rollout ms per control step and peak memory, beside phase
              7's one-process ms per control step
Then a JSON line with every kernel's numbers, the card's nvidia-smi line,
and as the last line {"ok": true, "device": {...}}. Any failure exits
non-zero before that line; a watchdog ends the run past 10 minutes. On an
NVIDIA H100 80GB HBM3 at 700 W the whole run has taken 389-510 s, phase
16 47-85 s of it: the margin, 90-210 s, is what a slow host may eat.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

WATCHDOG_S = 600
N_ENVS = 2048                 # kernel checks: envs of the captured substep
CLIPS24 = os.path.join("data_bank", "clips24.pkl")    # 24 takes x 150 frames
HARD_STATES = os.path.join("data_bank", "hard_states_getup.pkl")
SLICE_STEPS = 60
# the dense phase's seeded clips
DENSE_CLIPS, DENSE_FRAMES = 24, 120
# training: uhc.yml's n_envs; rollout depth cut from 48 to 8 control steps
TRAIN_ENVS, TRAIN_STEPS, TRAIN_ITERS = 1024, 8, 2
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# tolerances of the JAX package's own kernel tests
LTDL_ATOL = 1e-3              # tests/test_pallas_ltdl.py:48,60
PGS_RTOL, PGS_ATOL = 2e-4, 2e-5   # tests/test_pallas_pgs.py:69
CHOL_TOL = 5e-3               # tests/test_pallas_chol.py:22-47 (rtol = atol)
# the objects slice's kernel shapes (ROADMAP queue 1 item 2)
OBJ_SOLVE_WIDTHS = (49, 79)   # K2: 1 + 3 x 16 (compact_k), 1 + 3 x 26
OBJ_PSOR_BLOCKS = (24, 36)    # K3: 72 and 108 rows
SOLVE_RTOL = 1e-4             # K2, K4a, K4c on the substep's own systems, / max |x|
PARITY_ATOL = 1e-3            # qpos/qvel after one control step, f32 vs f64
REWARD_ATOL = 1e-4            # reward and its components after that step
GEN_ENVS, GEN_STEPS = 64, 8   # gen_states: one round
QUAT_ENVS = 8                 # the uhc_quatv2 env-step parity
WILD = os.path.join("data_bank", "wild_takes_r5.pkl")  # 12 takes, 120-188 frames
AR_ITER, AR_OUT = 800, "results_r5"   # results_r5/statear/kin_poly/models/
UHC_CKPT = os.path.join("results", "motion_im", "uhc", "models", "iter_13000.p")
AR_STEPS = 60                 # control steps of the AR phase
AR_WILD_PARITY = 4            # wild takes in the reported AR step parity
AR_TRAIN = os.path.join("data_bank", "ar_train_56.pkl")   # 56 takes, 9,540 frames
AR_INIT_STEPS, AR_FULL_STEPS = 3, 2   # warm-start steps at batch 256
AR_TRAIN_STEPS = 16           # rollout depth, cut from kin_poly.yml's 156
AR_TRAIN_EPOCHS = 2
ARNET_EPOCHS = 3
AR_BC_ENVS = 16               # the step-BC parity's recorded trajectory
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-3, 1e-2
# the use_of phase
WILD_OF = os.path.join("data_bank", "wild_takes_r5_of.pkl")   # the 12 takes + of
OF_ITER, OF_OUT = 0, "results_r4"     # results_r4/statear/use_of/models/
OF_TRAIN = os.path.join("data_bank", "action_takes_of.pkl")   # 24 x 150 frames
OF_INIT_STEPS, OF_FULL_STEPS = 3, 2   # warm-start steps at batch 256
OF_TRAIN_STEPS = 16                   # rollout depth, cut from use_of.yml's 125
OF_TRAIN_EPOCHS = 2
OF_FRAMES = 32                        # the flow clip, 64 x 64
OF_ATOL = 1e-3                        # flow features, card f32 vs CPU f64
# the uhc-modes phase
MODES_ITERS = 2
MODES_TIMED_STEPS = 3                 # host ms per control step, each mode
POSE_ALL_ATOL = 1e-6                  # eval_pose_all's mean row vs phase 10's
# the data phase
GROUND_TAKES = 4                      # clips24 takes through the grounding
GROUND_TIE = 1e-4                     # a grid margin under this is a near tie
AMASS_SEQS, AMASS_FPS = 6, 120.0      # seeded AMASS sequences of 4-8 s
DATA_ATOL = 1e-4                      # AMASS qpos, card f32 vs CPU f64
VIEW_STEPS = 1                        # viewer joints: 4-decimal rounding steps apart
FT_ENVS, FT_ATOL = 1024, 1e-5         # fine_tune rewards, card f32 vs CPU f64
# the zoo phase
ZOO_FRAMES = 150                      # LBS and fit_qpos: one 150-frame take
SMPL_V = 6890                         # SMPL's vertex count
LBS_ATOL = 1e-4                       # vertices and joints (m), card f32 vs CPU f64
FIT_ITERS, FIT_LR, FIT_SMOOTH = 300, 0.03, 0.01   # tests/test_retarget.py's fit
FIT_ERR = 0.03                        # mean joint error (m), tests/test_retarget.py:30
OCC_VOXELS, OCC_TIE = 16, 1e-5        # occupancy grid; a voxel this near a face is a tie
ZOO_RTOL = 1e-3                       # zoo nets, card f32 vs CPU f64, / max |output|
ZOO_IMAGES, ZOO_SEQ = 8, (4, 32, 128)  # 64 x 64 frames; (B, T, D) sequences
ROLLOUT_SAMPLES = 8192                # one UHC rollout: 1024 envs x 8 control steps
RL_ATOL = 1e-3                        # TRPO parameters, A2C gradients, f32 vs f64
# the dp phase
DP_RANKS = 2                          # ranks sharing the one card over gloo
DP_UHC_ENVS = TRAIN_ENVS // DP_RANKS  # envs per rank: phase 7's 1024, split
DP_STEPS = 2                          # data-parallel steps of each path
DP_AR_ENVS = 64                       # kin_poly.yml's n_envs, over both ranks
DP_AR_STEPS = 8                       # AR rollout depth, cut from 156
DP_PMEAN_RTOL = 1e-6                  # pmean_grads_ vs the ranks' mean, f32
T0 = time.perf_counter()


def say(phase: str, msg: str, t_phase: float) -> None:
    print(f"[{phase}] {msg} ({time.perf_counter() - t_phase:.2f} s, "
          f"total {time.perf_counter() - T0:.1f} s)", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _expire() -> None:
    print(f"FAILED: watchdog, still running after {WATCHDOG_S} s",
          file=sys.stderr, flush=True)
    ranks = sys.modules.get("kinpoly_tpu_torch.parallel.ranks")
    if ranks is not None:
        ranks.kill_all()
    os._exit(124)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flop: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_psor_system(n: int, k: int, seed: int):
    """Seeded SPD contact systems A = J J^T + 0.5 I with the engine's
    regularisation, ~30% inactive blocks (float32, bool active): the
    construction of tests/test_pallas_pgs.py, with the main path's block
    mix of 12 floor blocks (mu = 1) then 6 frictionless limit blocks."""
    rng = np.random.RandomState(seed)
    c = 3 * k
    J = rng.randn(n, c, 40)
    A = J @ np.swapaxes(J, -1, -2) + np.eye(c) * 0.5
    rhs = rng.randn(n, c)
    d = np.repeat(rng.uniform(0.85, 0.95, (n, k)), 3, -1)
    active = rng.rand(n, k) > 0.3
    R = (1 - d) / d * np.diagonal(A, axis1=-2, axis2=-1)
    R = np.where(np.repeat(active, 3, -1), R, 1e8)
    A3 = A.reshape(n, k, 3, k, 3)
    D = np.stack([A3[:, i, :, i, :] for i in range(k)], axis=1)
    D = D + R.reshape(n, k, 3)[..., None] * np.eye(3) + 1e-9 * np.eye(3)
    f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return (f32(A), f32(rhs), f32(np.linalg.inv(D)), f32(R),
            f32(np.broadcast_to(np.where(np.arange(k) < 12, 1.0, 0.0),
                                (n, k))), active)


def capture_substep(model, n: int, seed: int):
    """Run one substep of n envs and record the arguments of every kernel
    wrapper call (the engine calls them through their modules)."""
    import torch
    from kinpoly_tpu_torch.anim.spec import standing_pose
    from kinpoly_tpu_torch.physics import engine as eng
    from kinpoly_tpu_torch.physics import chol_cuda, ltdl_cuda, pgs_cuda

    wrappers = {"factor": (ltdl_cuda, "factor"), "solve": (ltdl_cuda, "solve"),
                "pgs": (pgs_cuda, "pgs_solve"), "chol": (chol_cuda, "solve_only")}
    calls = {k: [] for k in wrappers}
    orig = {k: getattr(mod, name) for k, (mod, name) in wrappers.items()}

    def rec(key, fn):
        def wrapped(*args, **kw):
            calls[key].append((args, kw))
            return fn(*args, **kw)
        return wrapped

    rng = np.random.RandomState(seed)
    q0, _ = standing_pose(model.spec)
    qpos = np.repeat(q0[None], n, axis=0)
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, 69))
    qpos[:, 2] -= rng.uniform(0.0, 0.02, n)
    qvel = rng.normal(0, 0.5, (n, 75))
    t = lambda x: torch.as_tensor(x, dtype=model.dtype, device=model.device)
    state = eng.SimState(t(qpos), t(qvel))
    if model.movable_objects:
        # every object parked as the AR env parks it, the box on the right
        # hand of each env
        n_obj = len(model.spec.objects)
        obj = np.zeros((n, n_obj, 7))
        obj[:, :, 0] = (np.arange(n_obj) + 1) * 100.0
        obj[:, :, 1] = 100.0
        obj[:, :, 3] = 1.0
        obj[:, 1, :3] = box_on_hand(model, state.qpos).cpu().numpy()
        state = state._replace(obj_qpos=t(obj), obj_qvel=t(np.zeros((n, n_obj, 6))))
    action = t(rng.normal(0, 0.3, (n, 75)))
    base_rot = t(np.asarray([0.7071, 0.7071, 0.0, 0.0], np.float32))
    plan = eng.build_contact_plan(model, state.qpos, state.obj_qpos)
    for k, (mod, name) in wrappers.items():
        setattr(mod, name, rec(k, orig[k]))
    try:
        out = eng.substep(model, state, action[:, :69], action[:, 69:],
                          t(qpos[:, 7:]), base_rot, plan)
    finally:
        for k, (mod, name) in wrappers.items():
            setattr(mod, name, orig[k])
    torch.cuda.synchronize()
    if not (torch.isfinite(out.qpos).all() and torch.isfinite(out.qvel).all()):
        fail("capture substep produced non-finite state")
    return {k: v for k, v in calls.items() if v}


def box_on_hand(model, qpos):
    """(N, 3) box position (object frame) that puts the box's top face, 0.02
    above its frame origin, 5 mm above the lowest contact vertex of each
    env's right hand: a contact."""
    import torch
    from kinpoly_tpu_torch.core import tmath
    from kinpoly_tpu_torch.physics import fk as fklib

    res = fklib.fk(model.st, qpos)
    hand = model.spec.body_index("R_Hand")
    world = res.xpos[:, hand, None, :] + tmath.quat_rot_vec(
        res.xquat[:, hand, None, :], model.cand_verts[model.cand_body == hand])
    p = world[torch.arange(world.shape[0], device=world.device),
              world[..., 2].argmin(dim=-1)]
    return torch.cat([p[:, :2], p[:, 2:] - 0.02 + 0.005], dim=-1)


def spd_systems(n: int, dim: int, seed: int) -> np.ndarray:
    """SPD systems as tests/test_pallas_chol.py builds them (float32)."""
    rng = np.random.RandomState(seed)
    J = rng.randn(n, dim, dim + 8).astype(np.float32)
    return (J @ np.swapaxes(J, -1, -2) + np.eye(dim, dtype=np.float32) * (dim * 0.1))


def chol_bound(n_env: int, n: int, nr: int, factor: bool, l_out: bool):
    """Bytes and flops the dense kernels need: the lower triangle of A (or
    L) read, B read, X (and L, n x n) written; the factor's n^3 / 3 flops
    and the two solves' 2 n^2 R."""
    tri = n * (n + 1) // 2
    n_bytes = 4 * n_env * (tri + 2 * n * nr + (n * n if l_out else 0))
    n_flop = n_env * ((n ** 3 / 3 if factor else 0) + 2 * n * n * nr)
    return bound_ms(n_bytes, n_flop)


def solver_launches(launches: dict) -> dict:
    """The launches of the solver kernels K1-K4c. K5 (``fk_tree``, with
    the frames ``fk_tree[frames]``) runs wherever FK runs on the card
    without a gradient, so the paths' exact counts leave it out; each
    path's K5 launches are in ``launches_by_path``."""
    return {k: v for k, v in launches.items() if not k.startswith("fk_tree")}


def check_fk_kernel(device) -> tuple[list[dict], str]:
    """K5, both modes, against the plain code on the card at the cell's
    1024 envs and the table's 2048: seeded poses of the synthetic
    humanoid (unnormalised roots, hinges up to +-4 pi), every output bit
    for bit the plain code's; ms per call of the kernel (graph-replayed,
    and through its wrapper) and of the plain code, and the byte bound:
    the qpos row read, xpos, xquat and xipos written (and the 75 axes and
    anchors with the frames). The flops (~130 per body, ~330 with the
    frames: the products, rotations and sines) are far below the bytes."""
    import torch
    from kinpoly_tpu_torch.anim.spec import spec_tensors, synthetic_spec
    from kinpoly_tpu_torch.physics import fk as fklib

    st = spec_tensors(synthetic_spec(0), torch.float32, device)
    n_body = len(st.parents)
    rng = np.random.RandomState(22)
    rows, msgs = {}, []
    for n in (1024, N_ENVS):
        q = np.zeros((n, 76))
        q[:, :3] = rng.uniform(-1.0, 1.0, (n, 3))
        q[:, 3:7] = rng.normal(0, 1, (n, 4))
        q[:, 7:] = rng.uniform(-4 * np.pi, 4 * np.pi, (n, 69))
        qpos = torch.tensor(q, dtype=torch.float32, device=device)

        def kernel(frames):
            if frames:
                res, df = fklib.fk_frames(st, qpos)
                return tuple(res) + tuple(df)
            return tuple(fklib.fk(st, qpos))

        def plain(frames):
            res = fklib._fk_plain(st, qpos)
            return tuple(res) + (tuple(fklib.dof_frames(st, qpos, res))
                                 if frames else ())

        for frames in (False, True):
            name = "fk_tree[frames]" if frames else "fk_tree"
            n_diff = sum(int((g != r).sum()) for g, r in
                         zip(kernel(frames), plain(frames)))
            if n_diff:
                fail(f"{name} at N={n}: {n_diff} outputs differ from the "
                     f"plain code's (K5 reproduces its float32 operations)")
            # a call's host work (checks, five allocations, the ctypes call)
            # outlasts its launch: the events time the wrapper, a CUDA graph
            # of 20 calls the device
            wrapper_ms = cuda_ms(lambda: kernel(frames), 50)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(20):
                    kernel(frames)
            ms = cuda_ms(graph.replay, 10) / 20
            plain_ms = cuda_ms(lambda: plain(frames), 5)
            out_floats = n_body * 10 + (2 * 3 * 75 if frames else 0)
            b, by = bound_ms(4 * n * (76 + out_floats),
                             n * n_body * (330 if frames else 130))
            msgs.append(f"{name} N={n} {ms:.4f} ms graph-replayed, wrapper "
                        f"{wrapper_ms:.4f} (plain {plain_ms:.3f}, bound {b:.5f}), "
                        f"bitwise equal to the plain code")
            row = rows.setdefault(name, dict(
                name=name, route="cuda", source="kinpoly_tpu_torch/csrc/fk.cu",
                replaces="none (kinpoly_tpu/physics/fk.py is plain jnp)",
                launches=None, library_ms=None, library=None))
            if n == N_ENVS:
                row.update(max_abs_err=0.0, ms=ms, wrapper_ms=wrapper_ms,
                           plain_ms=plain_ms, bound_ms=b, bound_by=by)
            else:
                row.update(ms_n1024=ms, wrapper_ms_n1024=wrapper_ms,
                           plain_ms_n1024=plain_ms, bound_ms_n1024=b)
    return list(rows.values()), " | ".join(msgs)


def check_chol_kernels(dense_model, device) -> tuple[list[dict], list[str]]:
    """K4a and K4c (R = 1 and 55) and K4b against their plain versions and
    float64, on the JAX test's SPD systems, and K4a and K4c on one dense
    substep's own systems (A = M + Kd dt with the stable-PD right-hand side;
    M with [tau - C, J^T])."""
    import torch
    from kinpoly_tpu_torch.physics import chol, chol_cuda

    calls = capture_substep(dense_model, N_ENVS, 0)
    if sorted((k, len(v)) for k, v in calls.items()) != [("chol", 2), ("pgs", 1)]:
        fail(f"a dense substep made {[(k, len(v)) for k, v in calls.items()]} "
             f"kernel calls")
    sub = {args[1].shape[-1]: args for args, _ in calls["chol"]}
    if sorted(sub) != [1, 55]:
        fail(f"dense solve widths {sorted(sub)}, expected [1, 55]")
    n = sub[1][0].shape[-1]
    A = torch.as_tensor(spd_systems(N_ENVS, n, 11), device=device)
    gen = torch.Generator(device=device).manual_seed(12)
    out, msgs = [], []

    def gate(name, got, plain, ref):
        """max |kernel - plain| within CHOL_TOL, and both within the JAX
        test's allclose(rtol = atol = CHOL_TOL) of float64."""
        err = float((got - plain).abs().max())
        for x in (got, plain):
            if not bool(((x.double() - ref).abs()
                         <= CHOL_TOL + CHOL_TOL * ref.abs()).all()):
                fail(f"{name}: outside rtol = atol = {CHOL_TOL} of float64")
        if not err < CHOL_TOL:
            fail(f"{name}: max abs err against the plain version {err:.3g}")
        return err

    for nr in (1, 55):
        name = f"chol_solve_only[R={nr}]"
        B = torch.randn(N_ENVS, n, nr, generator=gen, device=device)
        ref = torch.linalg.solve(A.double(), B.double())
        err = gate(name, chol_cuda.solve_only(A, B), chol.solve_only(A, B), ref)
        As, Bs = sub[nr]
        Xp = chol.solve_only(As, Bs)
        rel = float((chol_cuda.solve_only(As, Bs) - Xp).abs().max()
                    / Xp.abs().max())
        if not rel < SOLVE_RTOL:
            fail(f"{name} on the substep's systems: relative err {rel:.3g} "
                 f">= {SOLVE_RTOL}")
        b, by = chol_bound(N_ENVS, n, nr, factor=True, l_out=False)
        out.append(dict(
            name=name, route="cuda", source="kinpoly_tpu_torch/csrc/chol.cu",
            replaces="kinpoly_tpu/physics/pallas_chol.py:124",
            launches=None, max_abs_err=err,
            ms=cuda_ms(lambda: chol_cuda.solve_only(As, Bs), 50),
            plain_ms=cuda_ms(lambda: chol.solve_only(As, Bs), 3),
            bound_ms=b, bound_by=by,
            library_ms=cuda_ms(lambda: torch.linalg.solve(As, Bs), 20),
            library="torch.linalg.solve",
            # the nearer counterpart: the factor, then the two solves
            library_pair_ms=cuda_ms(lambda: torch.cholesky_solve(
                Bs, torch.linalg.cholesky_ex(As)[0]), 20),
            library_pair="torch.linalg.cholesky_ex + torch.cholesky_solve"))
        msgs.append(f"{name} err {err:.3g} (substep rel {rel:.3g}) "
                    f"{out[-1]['ms']:.4f} ms, cholesky_ex+cholesky_solve "
                    f"{out[-1]['library_pair_ms']:.4f} ms")

    # K4b and K4c: no engine caller. K4b timed on the substep's M at R = 55;
    # K4c on the substep's own systems factored by the plain version (M at
    # R = 55, M + Kd dt at R = 1), held there relative to max |x| as K4a is
    Ms, Bs = sub[55]
    B = torch.randn(N_ENVS, n, 55, generator=gen, device=device)
    L, X = chol_cuda.factor_solve(A, B)
    L_p, X_p = chol.factor_solve(A, B)
    if bool(torch.triu(L, 1).any()):
        fail("chol_factor_solve: L has entries above the diagonal")
    L64 = torch.linalg.cholesky(A.double())
    err_b = max(gate("chol_factor_solve L", L, L_p, L64),
                gate("chol_factor_solve X", X, X_p,
                     torch.linalg.solve(A.double(), B.double())))
    b, by = chol_bound(N_ENVS, n, 55, factor=True, l_out=True)
    out.append(dict(
        name="chol_factor_solve[R=55]", route="cuda",
        source="kinpoly_tpu_torch/csrc/chol.cu",
        replaces="kinpoly_tpu/physics/pallas_chol.py:160",
        launches=None, max_abs_err=err_b,
        ms=cuda_ms(lambda: chol_cuda.factor_solve(Ms, Bs), 50),
        plain_ms=cuda_ms(lambda: chol.factor_solve(Ms, Bs), 3),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.cholesky_solve(
            Bs, torch.linalg.cholesky_ex(Ms)[0]), 20),
        library="torch.linalg.cholesky_ex + torch.cholesky_solve (two calls)"))
    msgs.append(f"factor_solve err {err_b:.3g} {out[-1]['ms']:.4f} ms")
    for nr in (1, 55):
        name = f"chol_apply[R={nr}]"
        Bn = B[..., :nr].contiguous()
        err = gate(name, chol_cuda.apply(L_p, Bn), chol.apply(L_p, Bn),
                   torch.cholesky_solve(Bn.double(), L_p.double()))
        As, Bs = sub[nr]
        Ls = chol.factor(As)
        Xp = chol.apply(Ls, Bs)
        rel = float((chol_cuda.apply(Ls, Bs) - Xp).abs().max()
                    / Xp.abs().max())
        if not rel < SOLVE_RTOL:
            fail(f"{name} on the substep's systems: relative err {rel:.3g} "
                 f">= {SOLVE_RTOL}")
        b, by = chol_bound(N_ENVS, n, nr, factor=False, l_out=False)
        out.append(dict(
            name=name, route="cuda", source="kinpoly_tpu_torch/csrc/chol.cu",
            replaces="kinpoly_tpu/physics/pallas_chol.py:197",
            launches=None, max_abs_err=err,
            ms=cuda_ms(lambda: chol_cuda.apply(Ls, Bs), 50),
            plain_ms=cuda_ms(lambda: chol.apply(Ls, Bs), 3),
            bound_ms=b, bound_by=by,
            library_ms=cuda_ms(lambda: torch.cholesky_solve(Bs, Ls), 20),
            library="torch.cholesky_solve"))
        msgs.append(f"{name} err {err:.3g} (substep rel {rel:.3g}) "
                    f"{out[-1]['ms']:.4f} ms, cholesky_solve "
                    f"{out[-1]['library_ms']:.4f} ms")
    return out, msgs


def control_step_parity(card_model, cpu_model, bank_qpos,
                        with_contacts: bool = True, obj=None) -> float:
    """Max abs difference of qpos/qvel (and of the movable objects' state
    given `obj` = (obj_qpos, obj_qvel)) after one control step of 4 envs,
    card model against CPU model, from seeded states near the clips and a
    seeded action of the models' width."""
    import torch
    from kinpoly_tpu_torch.physics import engine as eng

    rng = np.random.RandomState(7)
    q0 = bank_qpos[:4, 0].double().cpu().numpy()
    qpos = q0.copy()
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (4, 69))
    qvel = rng.normal(0, 0.3, (4, 75))
    action = rng.normal(0, 0.2, (4, card_model.action_dim))
    base_rot = np.asarray([0.7071, 0.7071, 0.0, 0.0], np.float32)
    outs = []
    for m in (card_model, cpu_model):
        t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
        state = eng.SimState(t(qpos), t(qvel))
        if obj is not None:
            state = state._replace(obj_qpos=t(obj[0]), obj_qvel=t(obj[1]))
        s = eng.control_step(m, state, t(action), t(q0[:, 7:]), t(base_rot),
                             with_contacts=with_contacts)
        outs.append([x.double().cpu() for x in s if x is not None])
    return max(float((a - b).abs().max()) for a, b in zip(*outs))


def airborne_objects(n_obj: int, seed: int):
    """(obj_qpos, obj_qvel) of 4 envs: every object in the air away from the
    humanoid, tumbling (seeded velocities), for the contacts-off free
    fall."""
    rng = np.random.RandomState(seed)
    obj = np.zeros((4, n_obj, 7))
    obj[:, :, 0] = (np.arange(n_obj) + 1) * 3.0
    obj[:, :, 2] = 2.0
    q = rng.normal(0, 1, (4, n_obj, 4))
    obj[:, :, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return obj, rng.normal(0, 1.0, (4, n_obj, 6))


# uhc.yml with explicit residual forces on every body with torques,
# meta-PD and the local_rfc_explicit reward (a 315-wide action)
EXPLICIT_YML = """\
gamma: 0.95
tau: 0.95
policy_htype: relu
policy_hsize: [512, 256]
policy_lr: 5.0e-5
value_htype: relu
value_hsize: [512, 256]
value_lr: 3.0e-4
clip_epsilon: 0.2
min_batch_size: 50000
mini_batch_size: 32768
num_optim_epoch: 10
log_std: -2.3
fix_std: true
max_iter_num: 30000
seed: 1
save_model_interval: 100
reward_id: local_rfc_explicit
actor_type: mcp
num_primitive: 8
action_v: 1
obs_v: 1
reactive_v: 1
reactive_rate: 0.3
sampling_temp: 2
env_term_body: body
env_episode_len: 100000
obs_coord: root
obs_vel: full
residual_force: true
residual_force_scale: 100.0
residual_force_lim: 100.0
residual_force_mode: explicit
residual_force_bodies: all
residual_force_torque: true
meta_pd: true
base_rot: [0.7071, 0.7071, 0.0, 0.0]
reward_weights:
  w_p: 0.3
  w_v: 0.1
  w_e: 0.45
  w_c: 0.1
  w_vf: 0.05
  k_p: 2.0
  k_v: 0.005
  k_e: 5.0
  k_c: 100.0
  k_vf: 1.0
  w_cp: 0.1
  k_cp: 10.0
n_envs: 1024
rollout_steps: 48
"""


def host_ms_per_step(model, bank_qpos, n_envs: int, steps: int,
                     with_contacts: bool) -> tuple[float, int]:
    """Host ms per control step of `n_envs` envs (states near the clips,
    a seeded action), synchronised, after one warm-up step; and the aten
    operations the warm-up step dispatched (kernel wrappers included)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from kinpoly_tpu_torch.physics import engine as eng

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.RandomState(9)
    idx = np.arange(n_envs) % bank_qpos.shape[0]
    t = lambda x: torch.as_tensor(x, dtype=model.dtype, device=model.device)
    q0 = bank_qpos[idx, 0].double().cpu().numpy()
    state = eng.SimState(t(q0), t(rng.normal(0, 0.3, (n_envs, 75))))
    action = t(rng.normal(0, 0.2, (n_envs, model.action_dim)))
    base_rot = t(np.asarray([0.7071, 0.7071, 0.0, 0.0], np.float32))

    def step(s):
        return eng.control_step(model, s, action, t(q0[:, 7:]), base_rot,
                                with_contacts=with_contacts)

    with CountOps() as ops:
        step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, ops.n


def env_step_parity(cfg_name: str, card_model, cpu_model, takes: dict):
    """One env step of QUAT_ENVS envs under config `cfg_name`, env i on
    take i, card model against CPU model, from the same seeded action: max
    abs difference of qpos/qvel, and of the reward and its components."""
    import torch
    from kinpoly_tpu_torch.config.defaults import UHCConfig
    from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank

    cfg = UHCConfig.named(cfg_name).env_config()
    firsts = list(takes.values())[:QUAT_ENVS]
    action = np.random.RandomState(8).normal(0, 0.2, (QUAT_ENVS, 75))
    outs = []
    for m in (card_model, cpu_model):
        env = HumanoidImEnv(m, cfg, make_bank(m.spec, m, firsts), mode="test")
        state, _ = env.reset(torch.arange(QUAT_ENVS, device=m.device))
        state, _, reward, _, info = env.step(state, torch.as_tensor(
            action, dtype=m.dtype, device=m.device))
        outs.append([x.double().cpu() for x in
                     (state.sim.qpos, state.sim.qvel, reward, info.reward_info)])
    (q1, v1, r1, c1), (q2, v2, r2, c2) = outs
    return (max(float((q1 - q2).abs().max()), float((v1 - v2).abs().max())),
            max(float((r1 - r2).abs().max()), float((c1 - c2).abs().max())))


def ar_kernel_entries(device, kernels: list) -> tuple[list[dict], str]:
    """K2 at R = 49 and K3 at 24 blocks (72 rows) on one real AR substep of
    N_ENVS envs (five movable objects, compaction (16, 8), the box on each
    right hand): each against its plain version as the main shapes are
    (K2: unit-normal right-hand sides within LTDL_ATOL, the substep's own
    within SOLVE_RTOL of max |x|; K3: no farther from float64 than twice
    the float32 plain version), timed with its bound and library call."""
    import torch
    from kinpoly_tpu_torch.anim.spec import synthetic_spec
    from kinpoly_tpu_torch.config.defaults import uhc_control_params
    from kinpoly_tpu_torch.physics import contact as ct
    from kinpoly_tpu_torch.physics import engine as eng
    from kinpoly_tpu_torch.physics import ltdl, ltdl_cuda, pgs_cuda

    spec = synthetic_spec(with_objects=True)
    model = eng.build_model(spec, uhc_control_params(spec), device=device,
                            with_objects=True, movable_objects=True,
                            compact_k=(16, 8))
    calls = capture_substep(model, N_ENVS, 1)
    widths = sorted(a[2].shape[-1] for a, _ in calls["solve"])
    (args, kw), = calls["pgs"]
    if widths != [1, 49] or len(calls["factor"]) != 2 or args[1].shape[-1] != 72:
        fail(f"an AR substep solved widths {widths} and a PSOR of "
             f"{args[1].shape[-1]} rows, expected [1, 49] and 72")
    topo = model.topo
    depth = topo.depth.astype(float)
    n_valid = int((topo.depth + 1).sum())
    nv = topo.nv
    ref = {k["name"]: k for k in kernels}
    (fargs, _) = calls["factor"][1]                  # M, factored second
    sargs = next(a for a, _ in calls["solve"] if a[2].shape[-1] == 49)
    Rf, B = sargs[1], sargs[2]
    gen = torch.Generator(device=device).manual_seed(5)
    Bn = torch.randn(B.shape, generator=gen, device=device)
    err = float((ltdl_cuda.solve(topo, Rf, Bn) - ltdl.solve(topo, Rf, Bn))
                .abs().max())
    Xp = ltdl.solve(topo, Rf, B)
    rel = float((ltdl_cuda.solve(topo, Rf, B) - Xp).abs().max() / Xp.abs().max())
    if not err < LTDL_ATOL:
        fail(f"ltdl_solve[R=49] on the AR substep: max abs err {err:.3g}")
    if not rel < SOLVE_RTOL:
        fail(f"ltdl_solve[R=49] on the AR substep's right-hand sides: "
             f"relative err {rel:.3g} >= {SOLVE_RTOL}")
    L = torch.linalg.cholesky_ex(ltdl.unpack(topo, fargs[1]))[0]
    b2, by2 = bound_ms((N_ENVS * n_valid + 2 * B.numel()) * 4,
                       N_ENVS * 49 * (4 * float(depth.sum()) + nv))
    k2 = dict(name="ltdl_solve[R=49]", route="cuda",
              source="kinpoly_tpu_torch/csrc/ltdl.cu",
              replaces="kinpoly_tpu/physics/pallas_ltdl.py:118",
              launches=None, max_abs_err=err,
              ms=cuda_ms(lambda: ltdl_cuda.solve(topo, Rf, B), 50),
              plain_ms=cuda_ms(lambda: ltdl.solve(topo, Rf, B), 5),
              bound_ms=b2, bound_by=by2,
              library_ms=cuda_ms(lambda: torch.cholesky_solve(B, L), 20),
              library="torch.cholesky_solve")
    A, rhs, Dinv, Rr, mu, active = args[:6]
    iters = args[6] if len(args) > 6 else kw["iters"]
    C, K = rhs.shape[-1], mu.shape[-1]
    f_d = ct.psor_plain(*[x.double() if x.is_floating_point() else x
                          for x in args[:6]], iters)
    f_k = pgs_cuda.pgs_solve(*args[:6], iters)
    f_p = ct.psor_plain(*args[:6], iters)
    ek = float((f_k.double() - f_d).abs().max())
    ep = float((f_p.double() - f_d).abs().max())
    if not ek <= 2 * ep + PGS_ATOL:
        fail(f"pgs_solve on the AR substep's system: {ek:.3g} from float64, "
             f"the float32 plain version {ep:.3g}")
    b3, by3 = bound_ms(4 * (A.numel() + 3 * rhs.numel() + Dinv.numel()
                            + mu.numel()) + active.numel() * active.element_size(),
                       N_ENVS * iters * K * (3 * C * 2 + 9 * 2 + 12))
    k3 = dict(name="pgs_solve[C=72]", route="cuda",
              source="kinpoly_tpu_torch/csrc/pgs.cu",
              replaces="kinpoly_tpu/physics/pallas_pgs.py:115",
              launches=None, max_abs_err=float((f_k - f_p).abs().max()),
              ms=cuda_ms(lambda: pgs_cuda.pgs_solve(*args[:6], iters), 50),
              plain_ms=cuda_ms(lambda: ct.psor_plain(*args[:6], iters), 2),
              bound_ms=b3, bound_by=by3, library_ms=None, library=None)
    msg = (f"AR substep, N={N_ENVS}: ltdl_solve[R=49] err {err:.3g} (substep "
           f"rhs rel {rel:.3g}) {k2['ms']:.4f} ms (bound {b2:.4f}, "
           f"cholesky_solve {k2['library_ms']:.4f}; R=55 {ref['ltdl_solve[R=55]']['ms']:.4f}) "
           f"| pgs_solve C=72 kernel {ek:.3g}, plain {ep:.3g} from float64 "
           f"{k3['ms']:.4f} ms (bound {b3:.4f}; C=54 {ref['pgs_solve']['ms']:.4f})")
    return [k2, k3], msg


def ar_step_parity(takes, device, here: str, box_on_the_hand: bool,
                   cfg=None, iter_: int = AR_ITER, out: str = AR_OUT):
    """One AR env step of one env per take, card (float32, kernels) against
    the CPU float64 plain path, from the CPU's context bank (cast to the
    card) and the CPU policy's mean action: max abs difference of humanoid
    and object state, and of the reward and its components. With
    `box_on_the_hand` the box is moved onto each env's right hand at the
    reset pose. `cfg`, `iter_`, `out`: the named config and its checkpoint
    (kin_poly's iter_0800.p by default)."""
    import torch
    from kinpoly_tpu_torch.scripts import eval_ar_policy as ear

    kw = dict(uhc_checkpoint=os.path.join(here, UHC_CKPT),
              out_root=os.path.join(here, out), cfg=cfg)
    evs = [ear.build_eval(takes, iter_, device, **kw),
           ear.build_eval(takes, iter_, "cpu", torch.float64, **kw)]
    if not all(ev.loaded for ev in evs):
        fail(f"no AR checkpoint iter_{iter_:04d}.p under {out}")
    ctx = evs[1].ctx
    if box_on_the_hand:
        box = box_on_hand(evs[1].model, ctx.init_qpos)
        obj = ctx.obj_pose.clone()
        obj[:, :, :3] = box[:, None]
        ctx = ctx._replace(obj_pose=obj)
    outs, action = [], None
    for ev in (evs[1], evs[0]):
        m = ev.model
        ev.env.ctx = type(ctx)(*(None if x is None else x.to(
            device=m.device, dtype=m.dtype if x.is_floating_point() else x.dtype)
            for x in ctx))
        state, obs = ev.env.reset(torch.arange(len(takes), device=m.device))
        if action is None:
            with torch.no_grad():
                action = ev.agent.policy.action_mean(
                    ev.agent.policy.init_carry(len(takes), obs), obs)[1]
        with torch.no_grad():
            state, _, reward, _, info = ev.env.step(
                state, action.to(device=m.device, dtype=m.dtype))
        sim = state.sim
        outs.append([x.double().cpu() for x in (
            sim.qpos, sim.qvel, sim.obj_qpos, sim.obj_qvel, reward,
            info.reward_info)])
    (a, b) = outs
    return (max(float((x - y).abs().max()) for x, y in zip(a[:4], b[:4])),
            max(float((x - y).abs().max()) for x, y in zip(a[4:], b[4:])))


def run_training(device, iters: int, takes: dict, hard_states=None,
                 cfg=None, **model_kw) -> dict:
    """`iters` iterations of train_uhc's loop for the agent of `cfg`
    (uhc.yml by default) at TRAIN_ENVS envs and TRAIN_STEPS control steps
    over `takes`, through the kernels of the configuration that `model_kw`
    selects; launch counters set to 0 just before and read just after; the
    metrics stream written to a temporary directory and read back. Returns
    the launches, the timings, the stream's records and the agent."""
    import torch
    from kinpoly_tpu_torch import native
    from kinpoly_tpu_torch.config.defaults import UHCConfig
    from kinpoly_tpu_torch.rl import ppo
    from kinpoly_tpu_torch.scripts.train_uhc import build_trainer, train
    from kinpoly_tpu_torch.utils.logger import create_logger
    from kinpoly_tpu_torch.utils.metrics_log import MetricsLogger

    cfg = cfg or UHCConfig()
    agent = build_trainer(takes, cfg, TRAIN_ENVS, TRAIN_STEPS, hard_states,
                          device=device, **model_kw)
    start = [p.detach().clone() for p in agent.policy.parameters()]
    spent = {"rollout": 0.0, "ppo": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return res
        return run

    rollout, ppo_update = agent._rollout, ppo.ppo_update
    agent._rollout = timed("rollout", rollout)
    ppo.ppo_update = timed("ppo", ppo_update)
    with tempfile.TemporaryDirectory() as tmp:
        with MetricsLogger(tmp, run_name="uhc_uhc") as mlog:
            torch.cuda.synchronize()
            native.LAUNCHES.clear()
            t0 = time.perf_counter()
            try:
                train(agent, cfg, iters, mlog, create_logger())
                torch.cuda.synchronize()
            finally:
                agent._rollout, ppo.ppo_update = rollout, ppo_update
            wall = time.perf_counter() - t0
            launches = dict(native.LAUNCHES)
        with open(mlog.path) as f:
            metrics = [json.loads(line) for line in f]
    carry = agent._carry
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (carry.obs, carry.env_state.sim.qpos, carry.env_state.sim.qvel))
    for m in metrics:
        vals = [m["policy_loss"], m["value_loss"], m["reward_mean"],
                m["fail_frac"]] + [m[k] for k in m
                                   if k.startswith("reward_components/")]
        finite = finite and bool(np.isfinite(vals).all())
    moved = max(float((p.detach() - s).abs().max())
                for p, s in zip(agent.policy.parameters(), start))
    steps = iters * TRAIN_STEPS
    return dict(agent=agent, launches=launches, metrics=metrics,
                finite=finite, moved=moved, s_per_iter=wall / iters,
                ms_per_step=spent["rollout"] / steps * 1e3,
                ppo_ms=spent["ppo"] / iters * 1e3, steps=steps)


def checkpoint_round_trip(agent) -> bool:
    """save_checkpoint into a temporary directory, load it into fresh nets
    and norm: bit-identical policy outputs on the carried observations."""
    import torch
    from kinpoly_tpu_torch.models import weights
    from kinpoly_tpu_torch.rl import running_norm as rn
    from kinpoly_tpu_torch.rl.agent_uhc import make_policy

    with tempfile.TemporaryDirectory() as tmp:
        ck = weights.load_uhc_checkpoint(
            agent.save_checkpoint(os.path.join(tmp, "iter_smoke.p")))
    pol = make_policy(agent.cfg, agent.obs_dim, agent.env.action_dim)
    pol = pol.to(device=agent.env.model.device, dtype=agent.env.model.dtype)
    pol.load_state_dict(ck["policy"])
    norm = rn.RunningNorm(*(x.to(agent.env.model.device) for x in ck["norm"]))
    obs = agent._carry.obs
    with torch.no_grad():
        a = agent.policy(rn.apply(agent.norm, obs))
        b = pol(rn.apply(norm, obs))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def ar_warm_start(device, here: str, takes: list) -> dict:
    """(a) train_init from fresh weights at kin_poly.yml's widths and batch:
    the losses, seconds per step and whether the policy moved."""
    import torch
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    from kinpoly_tpu_torch.scripts import train_ar_policy as tap

    cfg = KinPolyConfig()
    agent = tap.build_agent(takes, cfg, cfg.train_config(), device,
                            uhc_checkpoint=os.path.join(here, UHC_CKPT))
    start = [p.detach().clone() for p in agent.policy.net.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, t = [], time.perf_counter()
    for tag, i, loss, nan_frac in agent.train_init(
            init_steps=AR_INIT_STEPS, full_steps=AR_FULL_STEPS, log_every=1):
        now = time.perf_counter()     # the loss's float() synced the card
        steps.append((tag, loss, nan_frac, now - t))
        t = now
    moved = max(float((p.detach() - s).abs().max())
                for p, s in zip(agent.policy.net.parameters(), start))
    return dict(steps=steps, moved=moved, batch=agent.cfg.batch_size,
                peak=torch.cuda.max_memory_allocated() / 2**30)


def ar_composite_epochs(device, here: str) -> dict:
    """(b) train_ar_policy resuming a copy of iter_0800.p with the joint
    controller, AR_TRAIN_EPOCHS epochs at AR_TRAIN_STEPS control steps,
    launches counted over the epochs; the metrics stream and the final
    checkpoint read back."""
    import shutil

    import torch
    from kinpoly_tpu_torch import native
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    from kinpoly_tpu_torch.models import weights
    from kinpoly_tpu_torch.rl.agent_ar import AgentAR
    from kinpoly_tpu_torch.scripts import train_ar_policy as tap

    cfg = KinPolyConfig()
    with tempfile.TemporaryDirectory() as tmp:
        mdir = cfg.model_dir(tmp)
        os.makedirs(mdir)
        shutil.copy(os.path.join(here, cfg.model_dir(AR_OUT),
                                 f"iter_{AR_ITER:04d}.p"), mdir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.LAUNCHES.clear()
        AgentAR.time_phases = True
        try:
            agent = tap.main([
                "--data", os.path.join(here, AR_TRAIN), "--uhc-checkpoint",
                os.path.join(here, UHC_CKPT), "--out", tmp, "--iter",
                str(AR_ITER), "--skip-init", "--joint-controller",
                "--max-epochs", str(AR_ITER + AR_TRAIN_EPOCHS),
                "--rollout-steps", str(AR_TRAIN_STEPS), "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            AgentAR.time_phases = False
        launches = dict(native.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(mdir, f"ar_{cfg.name}_metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        ck = weights.load_ar_checkpoint(os.path.join(
            mdir, f"iter_{AR_ITER + AR_TRAIN_EPOCHS:04d}.p"))
    same = (ck["epoch"] == agent.epoch and ck["cc"] is not None
            and all(torch.equal(ck[k][n].to(v.device), v)
                    for k, m in (("policy", agent.policy.net),
                                 ("value", agent.value), ("cc", agent.cc_policy))
                    for n, v in m.state_dict().items()))
    cc0, _ = tap.load_uhc(os.path.join(here, UHC_CKPT), "cpu")
    ck0 = weights.load_ar_checkpoint(os.path.join(
        here, cfg.model_dir(AR_OUT), f"iter_{AR_ITER:04d}.p"))
    if ck0["cc"] is not None:
        cc0.load_state_dict(ck0["cc"])
    with torch.no_grad():
        cc_moved = max(float((p.cpu() - q).abs().max()) for p, q in
                       zip(agent.cc_policy.parameters(), cc0.parameters()))
    return dict(agent=agent, launches=launches, metrics=metrics, same=same,
                cc_moved=cc_moved, peak=peak)


def step_bc_parity(agent) -> tuple[float, float]:
    """(d) one recorded trajectory (AR_BC_ENVS envs, the agent's rollout
    depth, sampled) through the step-BC loss and its gradient over every
    policy parameter, card float32 against a CPU float64 copy of the
    policy: (relative loss error, relative L2 error of the gradient)."""
    import torch
    from kinpoly_tpu_torch.anim.spec import spec_tensors
    from kinpoly_tpu_torch.models.policy_ar import PolicyAR
    from kinpoly_tpu_torch.rl import rollout_ar as roa

    batch = agent._get_batch(AR_BC_ENVS)
    ctx = agent.build_context(batch)
    carry = roa.init_ar_rollout_state(
        agent.env, agent.policy,
        torch.arange(AR_BC_ENVS, device=agent.device), ctx)
    _, traj = agent._rollout(carry, ctx, mean_action=False,
                             cc_policy=agent.cc_policy,
                             generator=agent.generator)
    cpu = PolicyAR(agent.policy.spec, spec_tensors(agent.policy.spec,
                                                   torch.float64, "cpu"),
                   agent.policy.cfg, agent.policy.log_std)
    cpu.net.load_state_dict(agent.policy.net.state_dict())
    cpu.net.double()
    out = []
    for pol, conv in ((agent.policy, lambda x: x),
                      (cpu, lambda x: x.detach().double().cpu())):
        masks = conv(traj.masks)
        prev = torch.cat([torch.ones_like(masks[:1]), masks[:-1]])
        loss, _ = pol.step_update_loss(conv(traj.obs), prev,
                                       conv(traj.curr_qpos), conv(traj.gt_qpos))
        grads = torch.autograd.grad(loss, list(pol.net.parameters()),
                                    allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          .double().cpu() for g, p in
                          zip(grads, pol.net.parameters())])
        out.append((float(loss), flat))
    (l32, g32), (l64, g64) = out
    return (abs(l32 - l64) / abs(l64),
            float(torch.linalg.norm(g32 - g64) / torch.linalg.norm(g64)))


def use_of_training(device, here: str) -> dict:
    """(c) train_ar_policy --cfg use_of --iter 0 --force-init on a copy of
    the tracked warm start in a temporary directory: OF_INIT_STEPS +
    OF_FULL_STEPS more warm-start steps, then OF_TRAIN_EPOCHS epochs at
    OF_TRAIN_STEPS control steps, launches counted over the whole run (the
    warm start runs no physics); the metrics stream and the final
    checkpoint read back."""
    import shutil

    import torch
    from kinpoly_tpu_torch import native
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    from kinpoly_tpu_torch.models import weights
    from kinpoly_tpu_torch.rl.agent_ar import AgentAR
    from kinpoly_tpu_torch.scripts import train_ar_policy as tap

    cfg = KinPolyConfig.named("use_of")
    with tempfile.TemporaryDirectory() as tmp:
        mdir = cfg.model_dir(tmp)
        os.makedirs(mdir)
        shutil.copy(os.path.join(here, cfg.model_dir(OF_OUT),
                                 f"iter_{OF_ITER:04d}.p"), mdir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.LAUNCHES.clear()
        AgentAR.time_phases = True
        t0 = time.perf_counter()
        try:
            agent = tap.main([
                "--cfg", "use_of", "--data", os.path.join(here, OF_TRAIN),
                "--uhc-checkpoint", os.path.join(here, UHC_CKPT), "--out",
                tmp, "--iter", str(OF_ITER), "--force-init", "--init-steps", str(OF_INIT_STEPS), "--full-steps",
                str(OF_FULL_STEPS), "--max-epochs", str(OF_TRAIN_EPOCHS),
                "--rollout-steps", str(OF_TRAIN_STEPS), "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            AgentAR.time_phases = False
        wall = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(mdir, f"ar_{cfg.name}_metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        path = os.path.join(mdir, f"iter_{OF_TRAIN_EPOCHS:04d}.p")
        layout = sorted(weights.read_checkpoint(path)["params"])
        ck = weights.load_ar_checkpoint(path)
    pol = agent.policy
    same = (layout == ["arnet", "delta"] and ck["epoch"] == agent.epoch
            and all(torch.equal(ck[k][n].to(v.device), v)
                    for k, m in (("policy", pol.net), ("delta", pol.delta_net),
                                 ("value", agent.value))
                    for n, v in m.state_dict().items()))
    return dict(agent=agent, launches=launches, metrics=metrics, same=same,
                layout=layout, peak=peak, wall=wall)


def seeded_of_takes(spec, n: int) -> list[dict]:
    """n seeded push takes of 8 frames (``standing_take``), each with
    seeded unit-normal flow features."""
    from kinpoly_tpu_torch.scripts import eval_ar_policy as ear

    takes = []
    for s in range(n):
        t = ear.standing_take(spec, 8, seed=s, action="push")
        t["of"] = np.random.RandomState(s).normal(
            size=(8, 512)).astype(np.float32)
        takes.append(t)
    return takes


def seeded_gray_clip(n: int, seed: int) -> np.ndarray:
    """(n, 64, 64) uint8: three Gaussian blobs drifting 1.5 and 0.7 pixels
    per frame over uniform noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:64, 0:64]
    frames = []
    for t in range(n):
        img = rng.uniform(0, 30, (64, 64))
        for cx, cy, r, a in ((20, 30, 8, 120), (44, 20, 6, 90),
                             (40, 48, 10, 60)):
            img += a * np.exp(-((xx - cx - 1.5 * t) ** 2
                                + (yy - cy - 0.7 * t) ** 2) / (2 * r * r))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames)


def grounding_picks(spec, q: np.ndarray, which: str, device):
    """The grounding grid search of one take, card f32 and CPU f64: (picks
    agree off near ties, number of near-tie frames, frames)."""
    import torch
    from kinpoly_tpu_torch.data import ground_fix as gf

    slots, bodies, max_delta, grid = (
        (gf.leg_slots(spec), gf.LEG_BODIES, 1.2, 49) if which == "legs"
        else (gf.arm_slots(spec), gf.ARM_BODIES, 0.9, 25))
    clearance = 0.005
    deltas, z_card = gf.grid_min_z(spec, q, slots, bodies, max_delta, grid,
                                   device=device, dtype=torch.float32)
    _, z_cpu = gf.grid_min_z(spec, q, slots, bodies, max_delta, grid,
                             device="cpu", dtype=torch.float64)
    pick_card = gf.pick_deltas(deltas, z_card, clearance)
    pick_cpu = gf.pick_deltas(deltas, z_cpu, clearance)
    margin = np.abs(z_cpu - clearance).min(axis=0)
    top2 = np.sort(z_cpu, axis=0)[-2:]
    none_ok = ~(z_cpu >= clearance).any(axis=0)
    margin = np.where(none_ok, np.minimum(margin, top2[1] - top2[0]), margin)
    tie = margin <= GROUND_TIE
    return bool(np.all((pick_card == pick_cpu) | tie)), int(tie.sum()), q.shape[0]


def write_amass_npz(root: str, n: int, fps: float, seed: int) -> None:
    """n seeded upright SMPL-H sequences of 4-8 s at fps, in two
    subdirectories: the root turned 90 deg about x (the SMPL frame's +y
    up), every joint on a slow random walk, the root drifting over the
    floor."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        T = int(fps * rng.uniform(4.0, 8.0))
        poses = np.zeros((T, 156))
        poses[:, 0] = np.pi / 2
        poses[:, :72] += 0.2 * rng.uniform(-1, 1, 72) + np.cumsum(
            rng.normal(0, 0.01, (T, 72)), axis=0)
        trans = np.zeros((T, 3))
        trans[:, :2] = np.cumsum(rng.normal(0, 0.005, (T, 2)), axis=0)
        trans[:, 2] = 0.92 + 0.02 * np.sin(np.linspace(0, 3, T))
        sub = os.path.join(root, f"subject{i % 2}")
        os.makedirs(sub, exist_ok=True)
        np.savez(os.path.join(sub, f"seq{i}_poses.npz"), poses=poses,
                 trans=trans, mocap_framerate=fps, betas=rng.randn(16))


def viewer_joints(path: str) -> list:
    """The joints of every sequence in a view_motion HTML's payload."""
    from kinpoly_tpu_torch.utils.html_viewer import _TEMPLATE

    head, tail = _TEMPLATE.split("__DATA__")
    with open(path) as f:
        html = f.read()
    if not (html.startswith(head) and html.endswith(tail)):
        fail(f"{path} is not the viewer template around its payload")
    data = json.loads(html[len(head):len(html) - len(tail)])
    return [np.asarray(sq["joints"]) for sq in data["seqs"]]


def fine_tune_parity(device) -> dict:
    """The three fine_tune rewards on FT_ENVS seeded envs (off tracking,
    every third env at its end), card f32 against CPU f64: max abs error
    over rewards and components, per id."""
    import torch
    from kinpoly_tpu_torch.core import tmath
    from kinpoly_tpu_torch.rl import rewards as rw

    rng = np.random.RandomState(16)
    n, dt = FT_ENVS, 1.0 / 30

    def quats(k):
        x = rng.randn(n, k, 4)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).reshape(n, 4 * k)

    prev_h = np.concatenate([rng.randn(n, 3), quats(1)], -1)
    cur_h = np.concatenate([prev_h[:, :3] + 0.01 * rng.randn(n, 3), quats(1)], -1)
    hvel = np.concatenate([(cur_h[:, :3] - prev_h[:, :3]) / dt, tmath.angvel_fd(
        torch.tensor(prev_h[:, 3:]), torch.tensor(cur_h[:, 3:]), dt).numpy()], -1)
    act = rng.randn(n, 75)
    raw = dict(head_pose=cur_h, prev_head_pose=prev_h,
               e_head_pose=np.concatenate([cur_h[:, :3] + 0.1 * rng.randn(n, 3),
                                           quats(1)], -1),
               e_head_vel=hvel + 0.3 * rng.randn(n, 6), bquat=quats(23),
               e_bquat=quats(23), action=act,
               old_action=act + 0.3 * rng.randn(n, 75),
               end_reward=np.full(n, 2.0), is_end=np.arange(n) % 3 == 0)
    ws = dict(w_end=0.5, k_p=2.0)
    errs = {}
    for rid in rw.FINE_TUNE_REWARDS:
        fn = rw.get_kin_poly_reward(rid)
        out = []
        for dev, dtype in ((device, torch.float32), ("cpu", torch.float64)):
            inp = rw.FineTuneInputs(**{
                k: torch.as_tensor(v, device=dev,
                                   dtype=torch.bool if v.dtype == bool else dtype)
                for k, v in raw.items()})
            r, c = fn(inp, ws, dt)
            out.append(torch.cat([r[:, None], c], -1).double().cpu())
        if not bool(torch.isfinite(out[0]).all()):
            fail(f"non-finite {rid} on the card")
        errs[rid] = float((out[0] - out[1]).abs().max())
    return errs


def data_phase(device, here: str, takes: dict, records: list,
               kernels: list) -> None:
    """Phase 14: the data path on the card against the CPU."""
    import torch
    from kinpoly_tpu_torch import native
    from kinpoly_tpu_torch.anim import mjcf
    from kinpoly_tpu_torch.anim.spec import synthetic_spec
    from kinpoly_tpu_torch.data import amass, ground_fix
    from kinpoly_tpu_torch.data.amass_dataset import AMASSDataset
    from kinpoly_tpu_torch.data.banks import read_bank
    from kinpoly_tpu_torch.scripts import view_motion

    native.LAUNCHES.clear()
    spec = synthetic_spec()

    # (a) grounding
    tp = time.perf_counter()
    qs = [np.asarray(q, np.float64) for q in list(takes.values())[:GROUND_TAKES]]
    rows = []
    for which in ("legs", "arms"):
        for q in qs:
            rows.append(grounding_picks(spec, q, which, device))
    agree = all(r[0] for r in rows)
    n_tie, n_frames = sum(r[1] for r in rows), sum(r[2] for r in rows)
    ground_legs_cpu = [ground_fix.ground_legs(spec, q, device="cpu",
                                              dtype=torch.float64)[0] for q in qs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    legs, fixed = [], []
    for q in qs:
        legs.append(ground_fix.ground_legs(spec, q, device=device)[0])
        fixed.append(ground_fix.ground_arms(spec, legs[-1], device=device)[0])
    torch.cuda.synchronize()
    ground_ms = (time.perf_counter() - t0) / len(qs) * 1e3
    lift = [ground_fix.max_root_lift(spec, q, device=device) for q in fixed]
    q_err = max(float(np.abs(a - b).max()) for a, b in zip(legs, ground_legs_cpu))
    say("data", f"(a) ground_legs + ground_arms on the first {len(qs)} takes of "
        f"{CLIPS24} ({qs[0].shape[0]} frames; grids of 49 x T and 25 x T "
        f"frames through one FK each): {ground_ms:.1f} ms per take on the card; "
        f"delta picks card f32 vs CPU f64 agree off near ties {agree} "
        f"({n_tie} near-tie frames of {n_frames}, margin <= {GROUND_TIE}); "
        f"ground_legs qpos max abs difference {q_err:.3g}; root lift still "
        f"needed after both " + ", ".join(f"{x:.4f}" for x in lift) + " m", tp)
    if not agree:
        fail("the grounding's delta picks differ between card and CPU off near ties")
    if not all(np.isfinite(q).all() for q in fixed):
        fail("non-finite grounded qpos")

    # (b) AMASS to takes, the dataset's bank, the MJCF parser
    tp = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "amass")
        write_amass_npz(root, AMASS_SEQS, AMASS_FPS, seed=14)
        out = os.path.join(tmp, "amass_takes.pkl")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tk = amass.process_amass_dir(spec, root, out_path=out, flip_augment=True,
                                     device=device)
        torch.cuda.synchronize()
        amass_ms = (time.perf_counter() - t0) / max(len(tk), 1) * 1e3
        ref = amass.process_amass_dir(spec, root, flip_augment=True,
                                      device="cpu", dtype=torch.float64)
        back = read_bank(out)
        t0 = time.perf_counter()
        bank = AMASSDataset(back).to_bank(spec, dt=1 / 30, device=device)
        torch.cuda.synchronize()
        bank_ms = (time.perf_counter() - t0) * 1e3
        spec_o = synthetic_spec(with_objects=True)
        xml = mjcf.export_global_mjcf(spec_o, os.path.join(tmp, "mjcf"))
        t0 = time.perf_counter()
        parsed = mjcf.parse_humanoid(xml)
        parse_ms = (time.perf_counter() - t0) * 1e3
    same_keys = sorted(tk) == sorted(ref)
    a_err = max(float(np.abs(tk[k]["qpos"] - ref[k]["qpos"]).max())
                for k in ref) if same_keys else float("inf")
    bank_ok = (sorted(back) == sorted(tk) and all(
        np.array_equal(back[k]["qpos"], tk[k]["qpos"]) for k in tk)
        and tuple(bank.qpos.shape) == (len(tk), max(
            t["qpos"].shape[0] for t in tk.values()), 76)
        and bool(torch.isfinite(bank.qpos).all()))
    parse_ok = (parsed.body_names == spec_o.body_names
                and np.array_equal(parsed.parents, spec_o.parents)
                and np.allclose(parsed.body_pos, spec_o.body_pos, atol=1e-12)
                and np.allclose(parsed.jnt_range, spec_o.jnt_range, atol=1e-12)
                and [o.name for o in parsed.objects] == [o.name for o in spec_o.objects])
    say("data", f"(b) process_amass_dir on {AMASS_SEQS} seeded sequences at "
        f"{AMASS_FPS:.0f} Hz with flip_augment: {len(tk)} takes of "
        f"{sorted(t['qpos'].shape[0] for t in tk.values())} frames, "
        f"{amass_ms:.1f} ms per take on the card; same takes as CPU f64 "
        f"{same_keys}, qpos max abs err {a_err:.3g} (tol {DATA_ATOL}); bank "
        f"read back and AMASSDataset.to_bank {tuple(bank.qpos.shape)} in "
        f"{bank_ms:.1f} ms: {bank_ok}; parse_humanoid of export_global_mjcf "
        f"(24 bodies, 24 STLs, 5 objects) {parse_ms:.1f} ms, recovered {parse_ok}", tp)
    if not same_keys or not a_err <= DATA_ATOL:
        fail(f"AMASS takes differ from the CPU's (same keys {same_keys}, "
             f"qpos err {a_err:.3g})")
    if not bank_ok:
        fail("the AMASS bank did not read back, or its ExpertClip bank is wrong")
    if not parse_ok:
        fail("parse_humanoid did not recover the exported humanoid")

    # (c) view_motion from a bank and from a record
    tp = time.perf_counter()
    wild = read_bank(os.path.join(here, WILD))
    push = next(k for k, v in wild.items() if v.get("action") == "push")
    v_err, view_ms = [], []
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, f"{AR_ITER:04d}_wild_take0_coverage_full.pkl")
        with open(rec, "wb") as f:
            pickle.dump(records[0], f)
        for args in (["--bank", os.path.join(here, WILD), "--take", push],
                     ["--result", rec]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = view_motion.main(args + ["--out", os.path.join(tmp, "card.html"),
                                            "--device", "cuda"])
            view_ms.append((time.perf_counter() - t0) * 1e3)
            cpu = view_motion.main(args + ["--out", os.path.join(tmp, "cpu.html"),
                                           "--device", "cpu"])
            jc, jh = viewer_joints(card), viewer_joints(cpu)
            if [j.shape for j in jc] != [j.shape for j in jh]:
                fail(f"view_motion {args[0]}: joints {[j.shape for j in jc]} "
                     f"on the card, {[j.shape for j in jh]} on the CPU")
            # joints are rounded to 4 decimals: count the rounding steps
            v_err.append(max(int(np.rint(np.abs(a - b) * 1e4).max())
                             for a, b in zip(jc, jh)))
    say("data", f"(c) view_motion --bank {WILD} --take {push} and --result on "
        f"phase 10's record of {records[0]['action']}: " + ", ".join(
            f"{ms:.1f} ms" for ms in view_ms) + " per file on the card; payload "
        f"joints card vs CPU at most " + ", ".join(str(e) for e in v_err)
        + f" steps of 1e-4 apart (tol {VIEW_STEPS})", tp)
    if not max(v_err) <= VIEW_STEPS:
        fail(f"view_motion joints differ from the CPU's by {max(v_err)} "
             f"rounding steps of 1e-4")

    # (d) the fine_tune rewards
    tp = time.perf_counter()
    errs = fine_tune_parity(device)
    say("data", f"(d) fine_tune rewards on {FT_ENVS} envs, card f32 vs CPU "
        f"f64, max abs err over reward and components: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {FT_ATOL}); "
        f"kernel launches in this phase {dict(native.LAUNCHES)}", tp)
    if not max(errs.values()) <= FT_ATOL:
        fail(f"fine_tune rewards differ from the CPU's: {errs}")
    for k in kernels:
        k["launches_by_path"]["data"] = native.LAUNCHES.get(k["name"], 0)


def rel_err(card, ref) -> float:
    """max |card - ref| over max |ref| (the plain difference where ref is
    all zero)."""
    import torch
    ref = ref.detach().double().cpu()
    err = float((card.detach().double().cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    return err / scale if scale > 0 else err


def zoo_nets():
    """(name, net, input shape, takes train) of every zoo net at its
    default widths."""
    from kinpoly_tpu_torch.models import aux_nets as an
    B, T, D = ZOO_SEQ
    img = (ZOO_IMAGES, 64, 64, 3)
    return [
        ("ResNet18", an.ResNet18(3), img, True),
        ("MobileNet", an.MobileNet(3), img, True),
        ("SimpleCNN", an.SimpleCNN(3), img, False),
        ("VideoRegNet", an.VideoRegNet(3, 76), (2, 16, 64, 64, 3), True),
        ("SpaceNet", an.SpaceNet(), (ZOO_IMAGES, 16, 16, 16, 1), False),
        ("TCN", an.TCN(D), (B, T, D), False),
        ("ERDNet", an.ERDNet(D, 76), (B, T, D), False),
        ("CMLP", an.CMLP(D, 76), (B, T, D), False),
        ("Discriminator", an.Discriminator(D), (B, T, D), False),
        ("VideoStateNet", an.VideoStateNet(D), (B, T, D), False),
        ("VideoForecastNet", an.VideoForecastNet(D), (B, T, D), False),
        ("PolicyDiscrete", an.PolicyDiscrete(D, 8), (B, T, D), False),
    ]


def zoo_phase(device, kernels: list) -> None:
    """Phase 15: the rest of anim, the model zoo, TRPO and A2C on the card
    against the CPU."""
    import copy

    import torch
    from kinpoly_tpu_torch import native
    from kinpoly_tpu_torch.anim import occupancy, retarget, smpl_model
    from kinpoly_tpu_torch.anim.spec import (spec_tensors, standing_pose,
                                             synthetic_spec)
    from kinpoly_tpu_torch.models import aux_nets, weights
    from kinpoly_tpu_torch.physics import contact as ct
    from kinpoly_tpu_torch.physics import fk as fklib

    native.LAUNCHES.clear()
    f64 = dict(device="cpu", dtype=torch.float64)
    f32 = dict(device=device, dtype=torch.float32)

    # (a) LBS at SMPL's sizes
    tp = time.perf_counter()
    model = smpl_model.synthetic_model(np.random.RandomState(15), V=SMPL_V)
    rng = np.random.RandomState(16)
    inputs = (rng.randn(ZOO_FRAMES, 10), rng.uniform(-0.5, 0.5, (ZOO_FRAMES, 72)),
              rng.randn(ZOO_FRAMES, 3))
    st = smpl_model.smpl_tensors(model, torch.float32, device)
    card_in = [torch.tensor(x, **f32) for x in inputs]
    lbs_ms = cuda_ms(lambda: smpl_model.lbs(st, *card_in), 5) / ZOO_FRAMES
    v_card, j_card = smpl_model.lbs(st, *card_in)
    v_cpu, j_cpu = smpl_model.lbs(model, *(torch.tensor(x, **f64) for x in inputs))
    v_err = float((v_card.double().cpu() - v_cpu).abs().max())
    j_err = float((j_card.double().cpu() - j_cpu).abs().max())
    say("zoo", f"(a) lbs of synthetic_model(V={SMPL_V}, 10 betas, 207 pose "
        f"blendshapes) on {ZOO_FRAMES} seeded frames: {lbs_ms:.4f} ms per frame "
        f"on the card; card f32 vs CPU f64 max abs err vertices {v_err:.3g}, "
        f"joints {j_err:.3g} m (tol {LBS_ATOL})", tp)
    if not (v_err <= LBS_ATOL and j_err <= LBS_ATOL):
        fail(f"lbs differs from the CPU's: vertices {v_err:.3g}, joints {j_err:.3g}")

    # (b) fit_qpos on a 150-frame take
    tp = time.perf_counter()
    spec = synthetic_spec()
    standing, _ = standing_pose(spec)
    rng = np.random.RandomState(17)
    q_true = np.repeat(standing[None], ZOO_FRAMES, 0)
    q_true[:, 7:] += rng.uniform(-0.2, 0.2, (ZOO_FRAMES, 69))
    q_true[:, :2] += rng.uniform(-0.2, 0.2, (ZOO_FRAMES, 2))
    target = fklib.fk(spec_tensors(spec, torch.float32, device),
                      torch.tensor(q_true, **f32)).xpos
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = retarget.fit_qpos(spec, target, standing, iters=FIT_ITERS, lr=FIT_LR,
                            w_smooth=FIT_SMOOTH)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_err = float(fit.jpos_err.mean())
    fit_ok = bool(torch.isfinite(fit.qpos).all()) and bool(torch.isfinite(fit.loss))
    say("zoo", f"(b) fit_qpos, {FIT_ITERS} Adam steps (lr {FIT_LR}, w_smooth "
        f"{FIT_SMOOTH}) from standing_pose on a {ZOO_FRAMES}-frame take (FK "
        f"targets of seeded qpos, hinges and root xy +-0.2): {fit_s:.2f} s per "
        f"take on the card; mean joint error {fit_err * 100:.2f} cm (bound "
        f"{FIT_ERR * 100:.0f} cm), last loss {float(fit.loss):.3g}, finite {fit_ok}", tp)
    if not (fit_err < FIT_ERR and fit_ok):
        fail(f"fit_qpos: mean joint error {fit_err:.4f} m, finite {fit_ok}")

    # (c) body occupancy
    tp = time.perf_counter()
    spec_o = synthetic_spec(with_objects=True)
    scene = ct.scene_from_spec(spec_o)
    n_obj = len(spec_o.objects)
    rng = np.random.RandomState(18)
    oq = rng.randn(n_obj, 4)
    oq /= np.linalg.norm(oq, axis=-1, keepdims=True)
    obj_qpos = np.concatenate([standing[None, :3] + rng.uniform(-0.4, 0.4, (n_obj, 3)),
                               oq], axis=-1)
    bodies = np.arange(spec_o.n_bodies)
    n_vox = n_tie = n_bad = 0
    occ_ms = []
    for obj in range(n_obj):
        args = (torch.tensor(standing, **f32), torch.tensor(obj_qpos, **f32), bodies, obj)
        occ_ms.append(cuda_ms(lambda: occupancy.body_occupancy(
            spec_o, scene, *args, voxel_num=OCC_VOXELS), 3))
        card = occupancy.body_occupancy(spec_o, scene, *args,
                                        voxel_num=OCC_VOXELS).cpu().numpy()
        cpu = [occupancy.body_occupancy(
            spec_o, scene._replace(size=scene.size + d), torch.tensor(standing, **f64),
            torch.tensor(obj_qpos, **f64), bodies, obj, voxel_num=OCC_VOXELS).numpy()
            for d in (0.0, -OCC_TIE, OCC_TIE)]
        tie = cpu[1] != cpu[2]          # within OCC_TIE of a face
        n_vox += int(cpu[0].sum())
        n_tie += int(tie.sum())
        n_bad += int(((card != cpu[0]) & ~tie).sum())
    say("zoo", f"(c) body_occupancy at voxel_num {OCC_VOXELS}, all "
        f"{spec_o.n_bodies} bodies of a standing body against each of the "
        f"{n_obj} objects: " + ", ".join(f"{m:.2f}" for m in occ_ms)
        + f" ms per object on the card; {n_vox} occupied voxels, card f32 vs "
        f"CPU f64 differ on {n_bad} voxels off the {n_tie} within {OCC_TIE} "
        f"of a geom face", tp)
    if n_bad:
        fail(f"body_occupancy: {n_bad} voxels differ from the CPU's off near ties")
    if not n_vox:
        fail("body_occupancy: no object overlaps any body's grid")

    # (d) the zoo nets at their default widths
    tp = time.perf_counter()
    gen = torch.Generator().manual_seed(19)
    rows, worst = [], 0.0
    for name, net, shape, bn in zoo_nets():
        aux_nets.init_flax_(net, gen)
        cpu_net = net.double()
        card_net = copy.deepcopy(cpu_net).to(device=device, dtype=torch.float32)
        x = np.random.RandomState(len(rows)).randn(*shape)
        if name == "SpaceNet":
            x = (x > 0.5).astype(np.float64)
        xc, xg = torch.tensor(x, **f64), torch.tensor(x, **f32)
        with torch.no_grad():
            out_cpu, out_card = cpu_net(xc), card_net(xg)
            errs = [rel_err(a, b) for a, b in zip(
                out_card if isinstance(out_card, tuple) else (out_card,),
                out_cpu if isinstance(out_cpu, tuple) else (out_cpu,))]
            ms = cuda_ms(lambda: card_net(xg), 5)
            if bn:          # one train=True BatchNorm update from the same stats
                errs.append(rel_err(card_net(xg, True), cpu_net(xc, True)))
                for (_, a), (_, b) in zip(card_net.named_buffers(),
                                          cpu_net.named_buffers()):
                    errs.append(rel_err(a, b))
        worst = max(worst, max(errs))
        rows.append(f"{name} {tuple(shape)} {ms:.2f} ms err {max(errs):.2g}")
    zs_ok, cat_ok, zs_m, cat_d = zoo_draws(device)
    say("zoo", "(d) zoo nets at default widths, flax initialisation drawn by "
        "init_flax_, card f32 vs CPU f64 relative to max |output| (forward, "
        "and for the BatchNorm nets one train=True pass and its updated "
        "statistics): " + "; ".join(rows) + f" (tol {ZOO_RTOL}); SpaceNet's "
        f"sampled z: standardised mean {zs_m[0]:.4f}, std {zs_m[1]:.4f}; "
        f"categorical_sample frequencies max |freq - softmax| {cat_d:.4f}", tp)
    if not worst <= ZOO_RTOL:
        fail(f"a zoo net differs from the CPU's by {worst:.3g} of its scale")
    if not (zs_ok and cat_ok):
        fail(f"draws off their targets: SpaceNet z {zs_m}, categorical {cat_d}")

    # (e) TRPO and A2C at uhc.yml's widths on one rollout's samples
    tp = time.perf_counter()
    ck = weights.load_uhc_checkpoint(UHC_CKPT)
    obs_dim = ck["value"]["mlp.layers.0.weight"].shape[1]
    # the primitive bank's last layer (256 wide in) gives the action width
    act_dim = next(v.shape[-1] for k, v in ck["policy"].items()
                   if k.startswith("bank.w_") and v.shape[1] == 256)
    rl = rl_phase(device, obs_dim, act_dim)
    say("zoo", f"(e) trpo_update and a2c_update, PolicyGaussian and Value "
        f"(512, 256) at obs {obs_dim}, action {act_dim}, on {ROLLOUT_SAMPLES} "
        f"samples: TRPO {rl['trpo_ms']:.1f} ms, accepted {rl['accepted']}, "
        f"surrogate {rl['loss0']:.5f} -> {rl['loss1']:.5f}, lm {rl['lm']:.4g} "
        f"(CPU f64 {rl['lm_cpu']:.4g}); A2C {rl['a2c_ms']:.1f} ms, losses "
        f"{rl['a2c_losses']}; card f32 vs CPU f64: TRPO's new parameters max "
        f"abs err {rl['trpo_err']:.3g} (tol {RL_ATOL}); A2C's losses and "
        f"gradients relative err {rl['a2c_loss_err']:.3g}, {rl['a2c_grad_err']:.3g} "
        f"(tol {RL_ATOL}), its new parameters max abs err {rl['a2c_err']:.3g} "
        f"(reported: Adam's first step moves a parameter by +-lr whatever its "
        f"gradient's size, so a gradient under float32's noise may step the "
        f"other way)", tp)
    if not (rl["accepted"] and rl["loss1"] < rl["loss0"]):
        fail(f"TRPO step not accepted or surrogate not improved: {rl}")
    if not all(np.isfinite(v) for v in rl["a2c_losses"] + [rl["loss0"], rl["loss1"]]):
        fail(f"non-finite RL losses: {rl}")
    if not (rl["trpo_err"] <= RL_ATOL and rl["a2c_grad_err"] <= RL_ATOL
            and rl["a2c_loss_err"] <= RL_ATOL):
        fail(f"RL updates differ from the CPU's: TRPO {rl['trpo_err']:.3g}, "
             f"A2C gradients {rl['a2c_grad_err']:.3g}, losses {rl['a2c_loss_err']:.3g}")

    # (f) no solver kernel lies on this path
    launched = dict(native.LAUNCHES)
    say("zoo", f"(f) kernel launches in this phase {launched}", tp)
    if solver_launches(launched):
        fail(f"the zoo phase launched solver kernels: {launched}")
    for k in kernels:
        k["launches_by_path"]["zoo"] = native.LAUNCHES.get(k["name"], 0)


def zoo_draws(device):
    """SpaceNet's z (standardised by its mean and scale) and
    categorical_sample's frequencies, drawn on the card."""
    import torch
    from kinpoly_tpu_torch.models import aux_nets

    net = aux_nets.SpaceNet(voxel_num=8).to(device)
    aux_nets.init_flax_(net, torch.Generator(device=device).manual_seed(20))
    vox = (torch.rand(4096, 8, 8, 8, 1, device=device,
                      generator=torch.Generator(device=device).manual_seed(21)) < 0.3
           ).float()
    zs = []
    hook = net.dec_in.register_forward_hook(lambda m, i, o: zs.append(i[0]))
    with torch.no_grad():
        _, mu, logvar = net(vox, generator=torch.Generator(device=device).manual_seed(22))
    hook.remove()
    eps = ((zs[0] - mu) / torch.exp(0.5 * logvar)).double()
    zs_m = (float(eps.mean()), float(eps.std()))
    logits = torch.randn(5, device=device, generator=torch.Generator(
        device=device).manual_seed(23)) * 1.5
    n = 1_000_000
    draws = aux_nets.categorical_sample(torch.Generator(device=device).manual_seed(24),
                                        logits.expand(n, 5))
    freq = torch.bincount(draws, minlength=5).double() / n
    cat_d = float((freq - torch.softmax(logits.double(), -1)).abs().max())
    return (abs(zs_m[0]) < 0.01 and abs(zs_m[1] - 1) < 0.01,
            cat_d < 5 * 0.5 / np.sqrt(n), zs_m, cat_d)


def rl_phase(device, obs_dim: int, act_dim: int) -> dict:
    """One trpo_update and one a2c_update on the card and on the CPU in
    float64 from the same seeded nets and samples."""
    import copy

    import torch
    from kinpoly_tpu_torch.models import nets
    from kinpoly_tpu_torch.rl import a2c, trpo

    gen = torch.Generator().manual_seed(25)
    pol = nets.init_flax_(nets.PolicyGaussian(obs_dim, act_dim), gen).double()
    val = nets.init_flax_(nets.Value(obs_dim), gen).double()
    rng = np.random.RandomState(26)
    obs = torch.tensor(rng.randn(ROLLOUT_SAMPLES, obs_dim))
    with torch.no_grad():
        mean, log_std = pol(obs)
    actions = mean + torch.exp(log_std) * torch.tensor(rng.randn(ROLLOUT_SAMPLES, act_dim))
    adv = torch.tensor(rng.randn(ROLLOUT_SAMPLES))
    ret = torch.tensor(rng.randn(ROLLOUT_SAMPLES))
    flp = nets.gaussian_log_prob(actions, mean, log_std)
    data = (obs, actions, adv, flp)
    out = {}
    res = {}
    for where in ("cpu", "card"):
        p, v = copy.deepcopy(pol), copy.deepcopy(val)
        if where == "card":
            p, v = p.to(device, torch.float32), v.to(device, torch.float32)
        p_a2c = copy.deepcopy(p)          # A2C starts from the same nets as TRPO
        d = [t.to(p.head.weight) for t in data]
        cfg = trpo.TRPOConfig()
        step = lambda: trpo.trpo_update(p, cfg, dict(p.named_parameters()), *d)
        if where == "card":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        new, info = step()
        if where == "card":
            torch.cuda.synchronize()
            out["trpo_ms"] = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            for k, t in new.items():
                p.get_parameter(k).copy_(t)
            m1, s1 = p(d[0])
            lp1 = nets.gaussian_log_prob(d[1], m1, s1)
            loss1 = float(-torch.mean(torch.exp(lp1 - d[3]) * d[2]))
        p = p_a2c
        opts = [torch.optim.Adam(n.parameters(), lr=1e-3, eps=1e-8) for n in (p, v)]
        if where == "card":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        a2 = a2c.a2c_update(p, v, opts[0], opts[1], d[0], d[1], d[2],
                            ret.to(d[0]), l2_reg=1e-3)
        if where == "card":
            torch.cuda.synchronize()
            out["a2c_ms"] = (time.perf_counter() - t0) * 1e3
        # Adam's first moment after one step is (1 - b1) g: the gradients
        # (each net's flattened, held against the net's largest component)
        grads = [torch.cat([opt.state[t]["exp_avg"].double().cpu().flatten() / 0.1
                            for t in n.parameters()]) for opt, n in zip(opts, (p, v))]
        res[where] = dict(info=info, loss1=loss1, a2=a2, trpo=new, grads=grads,
                          params=[t.detach().double().cpu() for t in
                                  list(p.parameters()) + list(v.parameters())])
    card, cpu = res["card"], res["cpu"]
    out.update(
        accepted=bool(card["info"]["accepted"]) and bool(cpu["info"]["accepted"]),
        loss0=float(card["info"]["loss0"]), loss1=card["loss1"],
        lm=float(card["info"]["lm"]), lm_cpu=float(cpu["info"]["lm"]),
        a2c_losses=[float(card["a2"][k]) for k in ("policy_loss", "value_loss")],
        trpo_err=max(float((card["trpo"][k].double().cpu() - cpu["trpo"][k]).abs().max())
                     for k in cpu["trpo"]),
        a2c_err=max(float((a - b).abs().max())
                    for a, b in zip(card["params"], cpu["params"])),
        a2c_grad_err=max(rel_err(a, b) for a, b in zip(card["grads"], cpu["grads"])),
        a2c_loss_err=max(abs(float(card["a2"][k]) - float(cpu["a2"][k]))
                         / max(abs(float(cpu["a2"][k])), 1e-12)
                         for k in ("policy_loss", "value_loss")))
    return out


def dp_phase(here: str, takes: dict, one_proc_ms: float, ar_rows: dict,
             kernels: list) -> None:
    """Phase 16: (c), (a), (b) in DP_RANKS gloo ranks on the card, then
    (d) in a one-rank NCCL group started after (b), so that no third
    process shares the host while (a) and (b) are timed."""
    from kinpoly_tpu_torch.anim.spec import synthetic_spec
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    from kinpoly_tpu_torch.parallel import dryrun as dp
    from kinpoly_tpu_torch.parallel.ranks import RankPool
    from kinpoly_tpu_torch.scripts import train_ar_policy as tap

    tp = time.perf_counter()
    gloo = RankPool(DP_RANKS, "gloo", "cuda", threads=2)
    try:
        # (c) the collective on CUDA tensors
        pm = gloo.run(dp.pmean_check_job, 7)
        say("dp", f"ranks up; (c) pmean_grads_ on {pm[0]['n']} float32 "
            f"gradients per rank over gloo on CUDA tensors: max error "
            f"relative to max |mean| " + ", ".join(
                f"rank {r} {x['rel_err']:.3g}" for r, x in enumerate(pm))
            + f" (tol {DP_PMEAN_RTOL}); None gradient kept "
            f"{all(x['none_kept'] for x in pm)}", tp)
        if not all(x["rel_err"] < DP_PMEAN_RTOL and x["none_kept"] for x in pm):
            fail(f"pmean_grads_ against the ranks' mean: {pm}")

        # (a) the data-parallel UHC step
        tp = time.perf_counter()
        ua = gloo.run(dp.uhc_job, takes, DP_UHC_ENVS, TRAIN_STEPS, DP_STEPS)
        check_dp_uhc("(a) uhc", ua, DP_RANKS, DP_STEPS, one_proc_ms, tp)

        # (b) the AR update with the group
        tp = time.perf_counter()
        cfg = KinPolyConfig()
        ar_takes = tap.get_takes(synthetic_spec(with_objects=True),
                                 os.path.join(here, AR_TRAIN))
        ab = gloo.run(dp.ar_job, ar_takes, os.path.join(here, UHC_CKPT),
                      os.path.join(here, cfg.model_dir(AR_OUT),
                                   f"iter_{AR_ITER:04d}.p"),
                      DP_AR_ENVS, DP_AR_STEPS, DP_STEPS)
        n = DP_STEPS * DP_AR_STEPS
        expect = {"ltdl_factor": 30 * n, "ltdl_solve[R=1]": 15 * n,
                  "ltdl_solve[R=49]": 15 * n, "pgs_solve": 15 * n}
        for r, x in enumerate(ab):
            ph = x["phase_s"]
            say("dp", f"(b) ar rank {r}: {DP_AR_ENVS // DP_RANKS} of "
                f"{DP_AR_ENVS} envs x {DP_AR_STEPS} control steps x "
                f"{DP_STEPS} steps from iter_{AR_ITER:04d}.p with the joint "
                f"controller: s per step {[round(t, 2) for t in x['step_s']]}"
                f", rollout {ph.get('rollout', 0) / n * 1e3:.1f} ms per "
                f"control step, context {ph.get('context', 0) / DP_STEPS:.2f}"
                f" s, PPO {ph.get('ppo', 0) / DP_STEPS * 1e3:.0f} ms, BC "
                f"{ph.get('bc', 0) / DP_STEPS * 1e3:.0f} ms, controller "
                f"{ph.get('controller', 0) / DP_STEPS * 1e3:.0f} ms per step; "
                f"peak {x['peak_gib']:.2f} GiB; context gap between ranks "
                f"before / after the broadcast {x['ctx_gaps']}; nets' gap "
                f"{x['gaps']}; launches {x['launches']} (expected {expect}); "
                "metrics " + "; ".join(
                    f"R {m['reward_mean']:.4f} ppo {m['ppo_loss']:.4g} bc "
                    f"{m['bc_loss']:.4g} cc {m['cc_loss']:.4g} pg "
                    f"{m['ppo_grad_norm']:.4g} bc_nan_frac "
                    f"{m['bc_nan_frac']:.2f}" for m in x["metrics"])
                + f"; controller moved {x['cc_moved']:.3g}", tp)
            if solver_launches(x["launches"]) != expect:
                fail(f"AR rank {r} launches {x['launches']} != {expect}")
            if any(g != (g[0], 0.0) for g in x["ctx_gaps"]):
                fail(f"AR rank {r}: the contexts differ after the broadcast")
            if any(g != 0.0 for g in x["gaps"]):
                fail(f"AR rank {r}: the ranks' nets differ: {x['gaps']}")
            if not x["finite"] or not x["cc_moved"] > 0:
                fail(f"AR rank {r}: non-finite metrics or the controller "
                     f"did not move")
            if any(m["bc_nan_frac"] != 0 or not m["ppo_grad_norm"] > 0
                   for m in x["metrics"]):
                fail(f"AR rank {r}: dead PPO or non-finite BC gradients")
        for k in kernels:
            k["launches_by_path"]["dp_ar_rank0"] = ab[0]["launches"].get(
                ar_rows.get(k["name"], ""), 0)
        for k in kernels:
            k["launches_by_path"]["dp_uhc_rank0"] = ua[0]["launches"].get(
                k["name"], 0)
    finally:
        gloo.close()

    # (d) one step in a one-rank NCCL group
    tp = time.perf_counter()
    with RankPool(1, "nccl", "cuda", threads=2) as nccl:
        ud = nccl.run(dp.uhc_job, takes, DP_UHC_ENVS, TRAIN_STEPS, 1)
    check_dp_uhc("(d) nccl", ud, 1, 1, one_proc_ms, tp)


def check_dp_uhc(tag: str, res: list, n_ranks: int, steps: int,
                 one_proc_ms: float, tp: float) -> None:
    """The checks of a data-parallel UHC run: launches per control step
    in each rank, the norm counting every rank's samples after each
    step, the ranks' nets bitwise equal, the policy moved, all finite."""
    n = steps * TRAIN_STEPS
    expect = {"ltdl_factor": 30 * n, "ltdl_solve[R=1]": 15 * n,
              "ltdl_solve[R=55]": 15 * n, "pgs_solve": 15 * n}
    counts = [float(n_ranks * DP_UHC_ENVS * TRAIN_STEPS * (i + 1))
              for i in range(steps)]
    for r, x in enumerate(res):
        say("dp", f"{tag} rank {r} of {n_ranks}: {DP_UHC_ENVS} envs x "
            f"{TRAIN_STEPS} control steps x {steps} steps: s per step "
            f"{[round(t, 2) for t in x['step_s']]}, rollout "
            f"{x['rollout_s'] / n * 1e3:.1f} ms per control step (phase 7, "
            f"one process at {TRAIN_ENVS} envs: {one_proc_ms:.1f}), peak "
            f"{x['peak_gib']:.2f} GiB; norm counts {x['counts']} (expected "
            f"{counts}); nets' gap between ranks {x['gaps']}; losses "
            f"{x['losses']}; policy moved {x['moved']:.3g}; launches "
            f"{x['launches']} (expected {expect})", tp)
        if solver_launches(x["launches"]) != expect:
            fail(f"{tag} rank {r} launches {x['launches']} != {expect}")
        if x["counts"] != counts:
            fail(f"{tag} rank {r} norm counts {x['counts']} != {counts}")
        if any(g != 0.0 for g in x["gaps"]):
            fail(f"{tag} rank {r}: the ranks' nets differ: {x['gaps']}")
        if not x["finite"] or not x["moved"] > 0:
            fail(f"{tag} rank {r}: non-finite or the policy did not move")


def main() -> None:
    watchdog = threading.Timer(WATCHDOG_S, _expire)
    watchdog.daemon = True
    watchdog.start()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)

    # 1. device -----------------------------------------------------------
    tp = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    # the port under test is the one in this checkout, never one found
    # elsewhere on the path
    if not os.path.isdir(os.path.join(here, "kinpoly_tpu_torch")):
        fail(f"no kinpoly_tpu_torch/ beside this script in {here}")
    import kinpoly_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            kinpoly_tpu_torch.__file__))) != here:
        fail(f"imported kinpoly_tpu_torch from {kinpoly_tpu_torch.__file__}, "
             f"not from {here}")
    from kinpoly_tpu_torch import native, resolve_device
    from kinpoly_tpu_torch.physics import engine as eng
    from kinpoly_tpu_torch.physics import contact as ct
    from kinpoly_tpu_torch.physics import ltdl, ltdl_cuda, pgs_cuda
    from kinpoly_tpu_torch.anim.spec import synthetic_spec
    from kinpoly_tpu_torch.config.defaults import uhc_control_params
    from kinpoly_tpu_torch.data.banks import load_hard_states, read_bank
    from kinpoly_tpu_torch.scripts import gen_states
    from kinpoly_tpu_torch.scripts.eval_uhc import (build_agent, get_takes,
                                                    mean_row, pose_metric_rows)

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say("device", f"{name} x{torch.cuda.device_count()}; nvidia-smi: {smi_line}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}", tp)

    # 2. build ------------------------------------------------------------
    tp = time.perf_counter()
    so, nvcc_s = native.build()
    native.library()
    say("build", f"{so.name}: nvcc {nvcc_s:.2f} s", tp)

    # 3. kernels against their plain versions -----------------------------
    tp = time.perf_counter()
    spec = synthetic_spec()
    model = eng.build_model(spec, uhc_control_params(spec), device=device)
    topo = model.topo
    calls = capture_substep(model, N_ENVS, 0)
    if sorted((k, len(v)) for k, v in calls.items()) != [
            ("factor", 2), ("pgs", 1), ("solve", 2)]:
        fail(f"a substep made {[(k, len(v)) for k, v in calls.items()]} "
             f"kernel calls")
    nv = topo.nv
    depth = topo.depth.astype(float)
    kernels = []

    # K1: both systems a substep factors (M + Kd dt, then M)
    Rs = [c[0][1] for c in calls["factor"]]
    err1 = max(float((ltdl_cuda.factor(topo, R) - ltdl.factor(topo, R)).abs().max())
               for R in Rs)
    R = Rs[0]
    k1_ms = cuda_ms(lambda: ltdl_cuda.factor(topo, R), 50)
    k1_plain = cuda_ms(lambda: ltdl.factor(topo, R), 5)
    dense = ltdl.unpack(topo, R)
    k1_lib = cuda_ms(lambda: torch.linalg.cholesky_ex(dense), 20)
    flop1 = N_ENVS * float(np.sum(depth * (depth + 1) + 2 * depth))
    # only the depth + 1 live slots of each packed row are read and written;
    # the rest of the (nv, Dmax+1) array is padding
    n_valid = int((topo.depth + 1).sum())
    b1, by1 = bound_ms(2 * N_ENVS * n_valid * 4, flop1)
    kernels.append(dict(
        name="ltdl_factor", route="cuda", source="kinpoly_tpu_torch/csrc/ltdl.cu",
        replaces="kinpoly_tpu/physics/pallas_ltdl.py:100",
        launches=None, max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain,
        bound_ms=b1, bound_by=by1, library_ms=k1_lib,
        library="torch.linalg.cholesky_ex"))
    if not err1 < LTDL_ATOL:
        fail(f"ltdl_factor max abs err {err1:.3g} >= {LTDL_ATOL}")

    # K2: the stable-PD solve (1 column) and the fused [tau - C, J^T] solve
    # (55 columns). The tolerance gate uses unit-normal right-hand sides, as
    # the JAX kernel test does; the substep's own right-hand sides reach
    # |x| ~ 1e3-1e4 (light distal bodies), so on those the error is held
    # relative to max |x| (float32 rounding over ~60 dependent updates)
    err2, rel2, k2 = 0.0, 0.0, {}
    L = torch.linalg.cholesky_ex(dense)[0]
    gen = torch.Generator(device=device).manual_seed(3)
    for (args, _) in calls["solve"]:
        Rf, B = args[1], args[2]
        nr = B.shape[-1]
        Bn = torch.randn(B.shape, generator=gen, device=device)
        err2 = max(err2, float((ltdl_cuda.solve(topo, Rf, Bn)
                                - ltdl.solve(topo, Rf, Bn)).abs().max()))
        Xp = ltdl.solve(topo, Rf, B)
        rel2 = max(rel2, float((ltdl_cuda.solve(topo, Rf, B) - Xp).abs().max()
                               / Xp.abs().max()))
        flop2 = N_ENVS * nr * (4 * float(depth.sum()) + nv)
        b2, by2 = bound_ms((N_ENVS * n_valid + 2 * B.numel()) * 4, flop2)
        k2[nr] = dict(ms=cuda_ms(lambda: ltdl_cuda.solve(topo, Rf, B), 50),
                      plain_ms=cuda_ms(lambda: ltdl.solve(topo, Rf, B), 5),
                      library_ms=cuda_ms(lambda: torch.cholesky_solve(B, L), 20),
                      bound_ms=b2, bound_by=by2)
    if sorted(k2) != [1, 55]:
        fail(f"solve widths {sorted(k2)}, expected [1, 55]")
    for nr in (55, 1):
        kernels.append(dict(
            name=f"ltdl_solve[R={nr}]", route="cuda",
            source="kinpoly_tpu_torch/csrc/ltdl.cu",
            replaces="kinpoly_tpu/physics/pallas_ltdl.py:118",
            launches=None, max_abs_err=err2, **k2[nr],
            library="torch.cholesky_solve"))
    if not err2 < LTDL_ATOL:
        fail(f"ltdl_solve max abs err {err2:.3g} >= {LTDL_ATOL}")
    if not rel2 < SOLVE_RTOL:
        fail(f"ltdl_solve on the substep's right-hand sides: relative err "
             f"{rel2:.3g} >= {SOLVE_RTOL}")
    # the objects slice's widths: 1 + 3 x 16 (compacted) and 1 + 3 x 26
    obj2 = []
    for nr in OBJ_SOLVE_WIDTHS:
        Bn = torch.randn((N_ENVS, nv, nr), generator=gen, device=device)
        e = float((ltdl_cuda.solve(topo, Rf, Bn) - ltdl.solve(topo, Rf, Bn))
                  .abs().max())
        if not e < LTDL_ATOL:
            fail(f"ltdl_solve[R={nr}] max abs err {e:.3g} >= {LTDL_ATOL}")
        obj2.append(f"R={nr} err {e:.3g} "
                    f"{cuda_ms(lambda: ltdl_cuda.solve(topo, Rf, Bn), 20):.4f} ms")

    # K3: PSOR. The tolerance gate runs on seeded SPD systems built as the
    # JAX kernel test builds them (tests/test_pallas_pgs.py), at the
    # main-path shapes. On the substep's own contact system (forces up to
    # ~5e3) float32 rounding alone moves a few small friction forces by
    # ~1e-3 between any two summation orders, so there the kernel is held
    # to the float64 solution: no farther from it than twice the float32
    # plain version is
    (args, kw), = calls["pgs"]
    A, rhs, Dinv, Rr, mu, active = args[:6]
    iters = args[6] if len(args) > 6 else kw["iters"]
    C, K = rhs.shape[-1], mu.shape[-1]
    rand = [torch.as_tensor(x, device=device)
            for x in random_psor_system(N_ENVS, K, seed=4)]
    f_k = pgs_cuda.pgs_solve(*rand, iters)
    f_p = ct.psor_plain(*rand, iters)
    err3 = float((f_k - f_p).abs().max())
    ok3 = bool(((f_k - f_p).abs() <= PGS_ATOL + PGS_RTOL * f_p.abs()).all())
    f64 = [x.double() if x.is_floating_point() else x for x in args[:6]]
    f_d = ct.psor_plain(*f64, iters)
    ek = float((pgs_cuda.pgs_solve(*args[:6], iters).double() - f_d).abs().max())
    ep = float((ct.psor_plain(*args[:6], iters).double() - f_d).abs().max())
    n_active = float(active.float().sum())
    flop3 = N_ENVS * iters * K * (3 * C * 2 + 9 * 2 + 12)
    b3, by3 = bound_ms(4 * (A.numel() + 3 * rhs.numel() + Dinv.numel()
                            + mu.numel())
                       + active.numel() * active.element_size(), flop3)
    kernels.append(dict(
        name="pgs_solve", route="cuda", source="kinpoly_tpu_torch/csrc/pgs.cu",
        replaces="kinpoly_tpu/physics/pallas_pgs.py:115",
        launches=None, max_abs_err=err3,
        ms=cuda_ms(lambda: pgs_cuda.pgs_solve(*args[:6], iters), 50),
        plain_ms=cuda_ms(lambda: ct.psor_plain(*args[:6], iters), 2),
        bound_ms=b3, bound_by=by3, library_ms=None, library=None))
    if not ok3:
        fail(f"pgs_solve outside rtol {PGS_RTOL} atol {PGS_ATOL} "
             f"(max abs err {err3:.3g})")
    if not ek <= 2 * ep + PGS_ATOL:
        fail(f"pgs_solve on the substep's system: {ek:.3g} from float64, the "
             f"float32 plain version {ep:.3g}")
    for kb in OBJ_PSOR_BLOCKS:
        sys_k = [torch.as_tensor(x, device=device)
                 for x in random_psor_system(N_ENVS, kb, seed=5)]
        fk, fp = pgs_cuda.pgs_solve(*sys_k, iters), ct.psor_plain(*sys_k, iters)
        if not bool(((fk - fp).abs() <= PGS_ATOL + PGS_RTOL * fp.abs()).all()):
            fail(f"pgs_solve at C={3 * kb} outside rtol {PGS_RTOL} atol "
                 f"{PGS_ATOL} (max abs err {float((fk - fp).abs().max()):.3g})")
        obj2.append(f"pgs C={3 * kb} err {float((fk - fp).abs().max()):.3g} "
                    f"{cuda_ms(lambda: pgs_cuda.pgs_solve(*sys_k, iters), 20):.4f} ms")
    say("kernels", f"N={N_ENVS}: factor err {err1:.3g} {k1_ms:.4f} ms | "
        f"solve err {err2:.3g} (substep rhs rel {rel2:.3g}) R=1 {k2[1]['ms']:.4f} ms R=55 "
        f"{k2[55]['ms']:.4f} ms | pgs err {err3:.3g} (substep system: kernel "
        f"{ek:.3g}, plain {ep:.3g} from float64, max |f| "
        f"{float(f_d.abs().max()):.3g}) {kernels[-1]['ms']:.4f} ms "
        f"({n_active:.0f} active blocks of {N_ENVS * K})", tp)
    say("kernels", f"N={N_ENVS}, objects-slice shapes: " + " | ".join(obj2), tp)

    tp = time.perf_counter()
    dense_model = eng.build_model(spec, uhc_control_params(spec), device=device,
                                  use_pallas_chol=True)
    chol_kernels, msgs = check_chol_kernels(dense_model, device)
    kernels += chol_kernels
    say("kernels", f"N={N_ENVS}, dense: " + " | ".join(msgs), tp)

    tp = time.perf_counter()
    fk_kernels, msg = check_fk_kernel(device)
    kernels += fk_kernels
    say("kernels", f"K5 (FK and the dof frames): {msg}", tp)

    # 4. the slice: UHC evaluation on the real bank through the kernels ---
    tp = time.perf_counter()
    takes = get_takes(os.path.join(here, CLIPS24))
    t_max = max(q.shape[0] for q in takes.values())
    agent = build_agent(13000, takes, device,
                        out_root=os.path.join(here, "results"))
    torch.cuda.synchronize()
    steps = SLICE_STEPS
    native.LAUNCHES.clear()
    t_run = time.perf_counter()
    cov, info = agent.eval_coverage(max_steps=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(native.LAUNCHES)
    expect = {"ltdl_factor": 30 * steps, "ltdl_solve[R=1]": 15 * steps,
              "ltdl_solve[R=55]": 15 * steps, "pgs_solve": 15 * steps}
    st = info["state"].sim
    finite = bool(torch.isfinite(st.qpos).all() and torch.isfinite(st.qvel).all())
    say("slice", f"{len(takes)} takes x {t_max} frames of {CLIPS24}, {steps} "
        f"control steps: coverage {cov:.4f}, mean tracked "
        f"{float(np.mean(info['percent'])):.1%}, "
        f"{run_s / steps * 1e3:.1f} ms per control step, launches {launches} "
        f"(expected {expect}), finite {finite}", tp)
    if solver_launches(launches) != expect:
        fail(f"kernel launches {launches} != {expect}")
    if not finite or tuple(st.qpos.shape) != (len(takes), 76):
        fail("non-finite or misshapen state after the evaluation")
    tp = time.perf_counter()
    rows = pose_metric_rows(agent, takes, steps)
    mean = mean_row(rows)
    say("slice", f"pose metrics of {steps} tracked steps, mean over "
        f"{len(rows)} takes: " + " ".join(f"{k}:{v:.3f}" for k, v in mean.items()),
        tp)
    if not all(np.isfinite(v) for r in rows.values() for v in r.values()):
        fail(f"non-finite pose metrics: {rows}")

    # 5. parity: card (f32, kernels) against the CPU plain path (f64) -----
    tp = time.perf_counter()
    cpu_model = eng.build_model(spec, uhc_control_params(spec), device="cpu",
                                dtype=torch.float64)
    bank_qpos = agent.env.bank.qpos
    perr = control_step_parity(model, cpu_model, bank_qpos)
    say("parity", f"one control step, 4 envs, card f32 vs CPU f64: max abs "
        f"err {perr:.3g} (tol {PARITY_ATOL})", tp)
    if not perr < PARITY_ATOL:
        fail(f"card vs CPU parity error {perr:.3g}")
    del agent

    # 6. quatv2: the other UHC config's env step and reward, card vs CPU --
    tp = time.perf_counter()
    qerr, rerr = env_step_parity("uhc_quatv2", model, cpu_model,
                                 get_takes(None, QUAT_ENVS, 4))
    say("quatv2", f"one env step of {QUAT_ENVS} envs under uhc_quatv2 "
        f"(reward quat_v2), card f32 vs CPU f64: state max abs err "
        f"{qerr:.3g} (tol {PARITY_ATOL}), reward and components {rerr:.3g} "
        f"(tol {REWARD_ATOL})", tp)
    if not qerr < PARITY_ATOL:
        fail(f"uhc_quatv2 card vs CPU state error {qerr:.3g}")
    if not rerr < REWARD_ATOL:
        fail(f"uhc_quatv2 card vs CPU reward error {rerr:.3g}")

    # 7. train: this slice's path, LTDL configuration, on the real bank ----
    tp = time.perf_counter()
    tr = run_training(device, TRAIN_ITERS, takes,
                      load_hard_states(os.path.join(here, HARD_STATES)))
    n = tr["steps"]
    expect = {"ltdl_factor": 30 * n, "ltdl_solve[R=1]": 15 * n,
              "ltdl_solve[R=55]": 15 * n, "pgs_solve": 15 * n}
    same = checkpoint_round_trip(tr["agent"])
    m = tr["metrics"][-1]
    say("train", f"{TRAIN_ENVS} envs x {TRAIN_STEPS} steps x {TRAIN_ITERS} "
        f"iterations on {CLIPS24} with {HARD_STATES} (reactive_v 2, "
        f"{len(tr['metrics'])} metrics lines read back): "
        f"{tr['s_per_iter']:.2f} s per iteration, rollout "
        f"{tr['ms_per_step']:.1f} ms per control step, PPO update "
        f"{tr['ppo_ms']:.1f} ms; last iteration reward {m['reward_mean']:.4f} "
        f"policy_loss {m['policy_loss']:.4g} value_loss {m['value_loss']:.4g}; "
        f"launches {tr['launches']} (expected {expect}); finite "
        f"{tr['finite']}; policy moved {tr['moved']:.3g}; checkpoint "
        f"round trip identical {same}", tp)
    if solver_launches(tr["launches"]) != expect:
        fail(f"training launches {tr['launches']} != {expect}")
    if [m["step"] for m in tr["metrics"]] != list(range(TRAIN_ITERS)):
        fail(f"metrics stream holds {len(tr['metrics'])} lines, not one per "
             f"iteration")
    if not tr["finite"]:
        fail("non-finite loss, reward or state in training")
    if not tr["moved"] > 0:
        fail("the policy did not change in training")
    if not same:
        fail("a reloaded checkpoint gives other policy outputs")
    for k in kernels:
        k["launches"] = tr["launches"].get(k["name"], 0)
        k["launches_by_path"] = {"uhc_train": k["launches"]}
    ltdl_ms = tr["ms_per_step"]
    # launches x ms at N = 2048 over the kernels of the LTDL path, per
    # control step of the training run
    k_ms = sum(k["launches"] * k["ms"] for k in kernels
               if k["name"].startswith(("ltdl_", "pgs_"))) / n
    say("train", f"LTDL kernel time per control step at N={N_ENVS}: "
        f"{k_ms:.3f} ms (sum of launches x ms over {n} control steps)", tp)
    del tr

    # 8. dense: the same training through K4a, and its parity ---------------
    tp = time.perf_counter()
    tr = run_training(device, 1, get_takes(None, DENSE_CLIPS, DENSE_FRAMES),
                      use_pallas_chol=True)
    n = tr["steps"]
    expect = {"chol_solve_only[R=1]": 15 * n, "chol_solve_only[R=55]": 15 * n,
              "pgs_solve": 15 * n}
    cpu_dense = eng.build_model(spec, uhc_control_params(spec), device="cpu",
                                dtype=torch.float64, use_pallas_chol=True)
    derr = control_step_parity(dense_model, cpu_dense, bank_qpos)
    say("dense", f"{TRAIN_ENVS} envs x {TRAIN_STEPS} steps x 1 iteration: "
        f"{tr['s_per_iter']:.2f} s, rollout {tr['ms_per_step']:.1f} ms per "
        f"control step (LTDL {ltdl_ms:.1f}), PPO update {tr['ppo_ms']:.1f} "
        f"ms; launches {tr['launches']} (expected {expect}); finite "
        f"{tr['finite']}; one control step card f32 vs CPU f64 max abs err "
        f"{derr:.3g} (tol {PARITY_ATOL})", tp)
    if solver_launches(tr["launches"]) != expect:
        fail(f"dense training launches {tr['launches']} != {expect}")
    if not tr["finite"]:
        fail("non-finite loss, reward or state in dense training")
    if not derr < PARITY_ATOL:
        fail(f"dense card vs CPU parity error {derr:.3g}")
    for k in kernels:
        k["launches_by_path"]["dense_train"] = tr["launches"].get(k["name"], 0)
        if k["name"].startswith("chol_solve_only"):
            k["launches"] = tr["launches"][k["name"]]
    # launches x ms at N = 2048 over the kernels of the dense path (K4a at
    # both widths, K3), per control step of the dense training run
    ms_of = {k["name"]: k["ms"] for k in kernels}
    d_ms = sum(c * ms_of[name] for name, c
               in solver_launches(tr["launches"]).items()) / n
    say("dense", f"dense kernel time per control step at N={N_ENVS}: "
        f"{d_ms:.3f} ms (sum of launches x ms over {n} control steps)", tp)
    del tr

    # 9. states: gen_states on clips24 into a temporary bank ---------------
    tp = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "hard_states.pkl")
        gen_states.main([
            "--data", os.path.join(here, CLIPS24), "--checkpoint",
            os.path.join(here, "results/motion_im/uhc/models/iter_13000.p"),
            "--n-envs", str(GEN_ENVS), "--steps", str(GEN_STEPS),
            "--rounds", "1", "--device", "cuda", "--out", out])
        hs = read_bank(out)
    k = hs["qpos"].shape[0]
    say("states", f"gen_states, {GEN_ENVS} envs x {GEN_STEPS} steps: {k} "
        f"states written and read back", tp)
    if (list(hs) != ["qpos", "qvel"] or hs["qpos"].shape != (k, 76)
            or hs["qvel"].shape != (k, 75) or hs["qpos"].dtype != np.float32
            or not np.isfinite(hs["qpos"]).all()):
        fail(f"gen_states bank reads back as {[(x, v.shape, v.dtype) for x, v in hs.items()]}")

    # 10. ar: the AR evaluation path on the wild takes ------------------------
    tp = time.perf_counter()
    from kinpoly_tpu_torch.scripts import eval_ar_policy as ear
    ar_k, msg = ar_kernel_entries(device, kernels)
    say("ar", msg, tp)
    tp = time.perf_counter()
    spec_o = synthetic_spec(with_objects=True)
    wild = ear.get_takes(spec_o, os.path.join(here, WILD))
    ev = ear.build_eval(wild, AR_ITER, device,
                        uhc_checkpoint=os.path.join(here, UHC_CKPT),
                        out_root=os.path.join(here, AR_OUT))
    torch.cuda.synchronize()
    if not ev.loaded:
        fail(f"no AR checkpoint iter_{AR_ITER:04d}.p under {AR_OUT}")
    ctx_s = time.perf_counter() - tp
    native.LAUNCHES.clear()
    t_run = time.perf_counter()
    traj = ear.rollout(ev, AR_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(native.LAUNCHES)
    expect = {"ltdl_factor": 30 * AR_STEPS, "ltdl_solve[R=1]": 15 * AR_STEPS,
              "ltdl_solve[R=49]": 15 * AR_STEPS, "pgs_solve": 15 * AR_STEPS}
    finite = all(bool(torch.isfinite(x).all()) for x in (
        traj.res_qpos, traj.obj_qpos, traj.actions, traj.rewards))
    rows, records = ear.take_rows(ev, traj)
    summ = ear.summary(rows, records)
    ar_eval_rows, ar_eval_records = rows, records   # phase 13 (d) reads them
    ar_ms = run_s / AR_STEPS * 1e3
    say("ar", f"{ev.n_takes} wild takes of {WILD} (longest "
        f"{ev.batch.qpos.shape[1]} frames), context {ctx_s:.2f} s; {AR_STEPS} "
        f"control steps: {ar_ms:.1f} ms per control step, launches {launches} "
        f"(expected {expect}), finite {finite}; success "
        f"{summ['succ']}, mean tracked {summ['mean']['percent']:.3f}; MEAN "
        + " ".join(f"{k}:{v:.3f}" for k, v in summ["mean"].items()), tp)
    if solver_launches(launches) != expect:
        fail(f"AR kernel launches {launches} != {expect}")
    if not finite or tuple(traj.obj_qpos.shape[1:]) != (ev.n_takes, 5, 7):
        fail("non-finite or misshapen humanoid or object state in the AR phase")
    if not all(np.isfinite(v) for r in rows for v in r.values()):
        fail(f"non-finite AR pose metrics or success: {rows}")
    ar_k[0]["launches"] = launches["ltdl_solve[R=49]"]
    ar_k[1]["launches"] = launches["pgs_solve"]
    for k in ar_k:
        k["launches_by_path"] = {}
    # the AR path's kernels by launch counter (K3 runs at 72 rows there)
    ar_rows = {"ltdl_factor": "ltdl_factor", "ltdl_solve[R=1]": "ltdl_solve[R=1]",
               "ltdl_solve[R=49]": "ltdl_solve[R=49]",
               "pgs_solve[C=72]": "pgs_solve", "fk_tree": "fk_tree",
               "fk_tree[frames]": "fk_tree[frames]"}
    for k in kernels + ar_k:
        k["launches_by_path"]["ar_eval"] = launches.get(
            ar_rows.get(k["name"], ""), 0)
    ms_of = {k["name"]: k["ms"] for k in kernels + ar_k}
    ar_kms = (30 * ms_of["ltdl_factor"] + 15 * ms_of["ltdl_solve[R=1]"]
              + 15 * ms_of["ltdl_solve[R=49]"] + 15 * ms_of["pgs_solve[C=72]"])
    kernels += ar_k
    say("ar", f"LTDL kernel time per AR control step at N={N_ENVS}: "
        f"{ar_kms:.3f} ms (30 x K1 + 15 x K2[R=1] + 15 x K2[R=49] + 15 x "
        f"K3[C=72])", tp)
    del ev, traj
    tp = time.perf_counter()
    seeded = [ear.standing_take(spec_o, 8, seed=s, action="push")
              for s in range(4)]
    qerr, rerr = ar_step_parity(seeded, device, here, box_on_the_hand=True)
    wq, wr = ar_step_parity(wild[:AR_WILD_PARITY], device, here,
                            box_on_the_hand=False)
    say("ar", f"one AR env step, 4 seeded push takes with the box on the "
        f"right hand, card f32 vs CPU f64: state and objects max abs err "
        f"{qerr:.3g} (tol {PARITY_ATOL}), reward and components {rerr:.3g} "
        f"(tol {REWARD_ATOL}); on the first {AR_WILD_PARITY} wild takes "
        f"(reported, not gated): {wq:.3g} and {wr:.3g}", tp)
    if not qerr < PARITY_ATOL:
        fail(f"AR card vs CPU state error {qerr:.3g}")
    if not rerr < REWARD_ATOL:
        fail(f"AR card vs CPU reward error {rerr:.3g}")

    # 11. ar-train: AR training at full widths -------------------------------
    tp = time.perf_counter()
    from kinpoly_tpu_torch.scripts import exp_arnet
    from kinpoly_tpu_torch.scripts import train_ar_policy as tap
    ar_takes = tap.get_takes(spec_o, os.path.join(here, AR_TRAIN))
    ws = ar_warm_start(device, here, ar_takes)
    init_s = [x[3] for x in ws["steps"] if x[0] == "init"]
    full_s = [x[3] for x in ws["steps"] if x[0] == "full"]
    ws_finite = all(np.isfinite(x[1]) for x in ws["steps"])
    say("ar-train", f"(a) warm start at batch {ws['batch']} on {AR_TRAIN} "
        f"({len(ar_takes)} takes): losses " + ", ".join(
            f"{x[0]} {x[1]:.4g} (nan_frac {x[2]:.2f}, {x[3] * 1e3:.0f} ms)"
            for x in ws["steps"]) + f"; init steps after the first "
        f"{np.mean(init_s[1:]) * 1e3:.1f} ms, full steps "
        f"{np.mean(full_s) * 1e3:.1f} ms; policy moved {ws['moved']:.3g}; "
        f"peak memory {ws['peak']:.2f} GiB", tp)
    if not ws_finite:
        fail(f"non-finite warm-start loss: {ws['steps']}")
    if not ws["moved"] > 0:
        fail("the warm start did not move the policy")
    del ws
    tp = time.perf_counter()
    ce = ar_composite_epochs(device, here)
    n = AR_TRAIN_EPOCHS * AR_TRAIN_STEPS
    expect = {"ltdl_factor": 30 * n, "ltdl_solve[R=1]": 15 * n,
              "ltdl_solve[R=49]": 15 * n, "pgs_solve": 15 * n}
    ms = ce["metrics"]
    keys = ("reward_mean", "ppo_loss", "value_loss", "bc_loss", "cc_loss",
            "fail_frac", "ratio_dev", "ppo_grad_norm", "adv_std",
            "bc_nan_frac", "T_iter")
    finite = all(k in m and np.isfinite(m[k]) for m in ms for k in keys)
    ph = ce["agent"].phase_s
    say("ar-train", f"(b) train_ar_policy --iter {AR_ITER} --skip-init "
        f"--joint-controller, {AR_TRAIN_EPOCHS} epochs of 64 envs x "
        f"{AR_TRAIN_STEPS} control steps: " + "; ".join(
            f"epoch {m['step']}: {m['T_iter']:.2f} s, R {m['reward_mean']:.4f}, "
            f"bc {m['bc_loss']:.4g}, ppo {m['ppo_loss']:.4g}, cc "
            f"{m['cc_loss']:.4g}, fail {m['fail_frac']:.3f}, |r-1| "
            f"{m['ratio_dev']:.4g}, pg {m['ppo_grad_norm']:.4g}, "
            f"bc_nan_frac {m['bc_nan_frac']:.3f}" for m in ms)
        + f"; per epoch: context {ph.get('context', 0) / AR_TRAIN_EPOCHS:.3f} s, "
        f"rollout {ph.get('rollout', 0) / n * 1e3:.1f} ms per control step, "
        f"PPO {ph.get('ppo', 0) / AR_TRAIN_EPOCHS * 1e3:.1f} ms, BC "
        f"{ph.get('bc', 0) / AR_TRAIN_EPOCHS * 1e3:.1f} ms, controller "
        f"{ph.get('controller', 0) / AR_TRAIN_EPOCHS * 1e3:.1f} ms; launches "
        f"{ce['launches']} (expected {expect}); controller moved "
        f"{ce['cc_moved']:.3g}; checkpoint read back equal {ce['same']}; "
        f"peak memory {ce['peak']:.2f} GiB", tp)
    if solver_launches(ce["launches"]) != expect:
        fail(f"AR training launches {ce['launches']} != {expect}")
    if len(ms) != AR_TRAIN_EPOCHS or not finite:
        fail(f"AR training metrics missing or non-finite: {ms}")
    if not all(m["ppo_grad_norm"] > 0 and m["ratio_dev"] > 0 for m in ms):
        fail("dead PPO: ppo_grad_norm or ratio_dev is 0")
    if any(m["bc_nan_frac"] != 0 for m in ms):
        fail("non-finite step-BC gradients (bc_nan_frac > 0)")
    if not ce["cc_moved"] > 0:
        fail("the joint controller did not move")
    if not ce["same"]:
        fail("the final AR checkpoint reads back different")
    for k in kernels:
        k["launches_by_path"]["ar_train"] = ce["launches"].get(
            ar_rows.get(k["name"], ""), 0)
        if k["name"] in ("ltdl_solve[R=49]", "pgs_solve[C=72]"):
            k["launches"] = k["launches_by_path"]["ar_train"]
    tp = time.perf_counter()
    loss_rel, grad_rel = step_bc_parity(ce["agent"])
    del ce
    with tempfile.TemporaryDirectory() as tmp:
        _, arnet_losses = exp_arnet.main([
            "--data", os.path.join(here, AR_TRAIN), "--epochs",
            str(ARNET_EPOCHS), "--out", tmp, "--device", "cuda"])
    say("ar-train", f"(c) exp_arnet, {ARNET_EPOCHS} epochs of 64 windows: "
        f"losses {[round(x, 4) for x in arnet_losses]}; (d) step-BC loss on "
        f"one trajectory of {AR_BC_ENVS} envs x {AR_TRAIN_STEPS} steps, card "
        f"f32 vs CPU f64: loss rel err {loss_rel:.3g} (tol {STEP_LOSS_RTOL}), "
        f"gradient rel L2 err {grad_rel:.3g} (tol {STEP_GRAD_RTOL})", tp)
    if len(arnet_losses) != ARNET_EPOCHS or not np.isfinite(arnet_losses).all():
        fail(f"exp_arnet losses {arnet_losses}")
    if not loss_rel < STEP_LOSS_RTOL:
        fail(f"step-BC loss card vs CPU rel err {loss_rel:.3g}")
    if not grad_rel < STEP_GRAD_RTOL:
        fail(f"step-BC gradient card vs CPU rel L2 err {grad_rel:.3g}")

    # 12. use_of: policy_v 2 and the optical-flow features --------------------
    tp = time.perf_counter()
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    from kinpoly_tpu_torch.data import video
    of_cfg = KinPolyConfig.named("use_of")
    wild_of = ear.get_takes(spec_o, os.path.join(here, WILD_OF))
    ev = ear.build_eval(wild_of, OF_ITER, device,
                        uhc_checkpoint=os.path.join(here, UHC_CKPT),
                        out_root=os.path.join(here, OF_OUT), cfg=of_cfg)
    torch.cuda.synchronize()
    if not ev.loaded:
        fail(f"no use_of checkpoint iter_{OF_ITER:04d}.p under {OF_OUT}")
    if ev.agent.policy.policy_v != 2 or ev.ctx.of is None:
        fail("the use_of evaluation runs no residual head or no flow features")
    ctx_s = time.perf_counter() - tp
    native.LAUNCHES.clear()
    t_run = time.perf_counter()
    traj = ear.rollout(ev, AR_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(native.LAUNCHES)
    expect = {"ltdl_factor": 30 * AR_STEPS, "ltdl_solve[R=1]": 15 * AR_STEPS,
              "ltdl_solve[R=49]": 15 * AR_STEPS, "pgs_solve": 15 * AR_STEPS}
    finite = all(bool(torch.isfinite(x).all()) for x in (
        traj.res_qpos, traj.obj_qpos, traj.actions, traj.rewards))
    rows, records = ear.take_rows(ev, traj)
    summ = ear.summary(rows, records)
    say("use_of", f"(a) eval_ar_policy --cfg use_of --iter {OF_ITER} on the "
        f"{ev.n_takes} takes of {WILD_OF} (longest {ev.batch.qpos.shape[1]} "
        f"frames), context {ctx_s:.2f} s; {AR_STEPS} control steps: "
        f"{run_s / AR_STEPS * 1e3:.1f} ms per control step, launches "
        f"{launches} (expected {expect}), finite {finite}; coverage "
        f"{summ['coverage']:.4f}, success {summ['succ']}; MEAN "
        + " ".join(f"{k}:{v:.3f}" for k, v in summ["mean"].items()), tp)
    if solver_launches(launches) != expect:
        fail(f"use_of kernel launches {launches} != {expect}")
    if not finite or tuple(traj.actions.shape[1:]) != (ev.n_takes, 76):
        fail("non-finite or misshapen state, action or reward in use_of")
    if not all(np.isfinite(v) for r in rows for v in r.values()):
        fail(f"non-finite use_of pose metrics or success: {rows}")
    for k in kernels:
        k["launches_by_path"]["use_of_eval"] = launches.get(
            ar_rows.get(k["name"], ""), 0)
    del ev, traj
    tp = time.perf_counter()
    qerr, rerr = ar_step_parity(seeded_of_takes(spec_o, 4), device, here,
                                box_on_the_hand=True, cfg=of_cfg,
                                iter_=OF_ITER, out=OF_OUT)
    say("use_of", f"(b) one AR env step under policy_v 2, 4 seeded push "
        f"takes with the box on the right hand, card f32 vs CPU f64: state "
        f"and objects max abs err {qerr:.3g} (tol {PARITY_ATOL}), reward "
        f"and components {rerr:.3g} (tol {REWARD_ATOL})", tp)
    if not qerr < PARITY_ATOL:
        fail(f"use_of card vs CPU state error {qerr:.3g}")
    if not rerr < REWARD_ATOL:
        fail(f"use_of card vs CPU reward error {rerr:.3g}")
    tp = time.perf_counter()
    ot = use_of_training(device, here)
    n = OF_TRAIN_EPOCHS * OF_TRAIN_STEPS
    expect = {"ltdl_factor": 30 * n, "ltdl_solve[R=1]": 15 * n,
              "ltdl_solve[R=49]": 15 * n, "pgs_solve": 15 * n}
    ms = ot["metrics"]
    finite = all(k in m and np.isfinite(m[k]) for m in ms for k in keys)
    ph = ot["agent"].phase_s
    say("use_of", f"(c) train_ar_policy --cfg use_of --iter {OF_ITER} "
        f"--force-init on {OF_TRAIN}: warm start of {OF_INIT_STEPS} init-state and {OF_FULL_STEPS} full-AR "
        f"steps at batch {ot['agent'].cfg.batch_size}, then "
        f"{OF_TRAIN_EPOCHS} epochs of {ot['agent'].cfg.n_envs} envs x "
        f"{OF_TRAIN_STEPS} control steps, {ot['wall']:.1f} s in all: "
        + "; ".join(
            f"epoch {m['step']}: {m['T_iter']:.2f} s, R {m['reward_mean']:.4f}, "
            f"bc {m['bc_loss']:.4g}, ppo {m['ppo_loss']:.4g}, fail "
            f"{m['fail_frac']:.3f}, |r-1| {m['ratio_dev']:.4g}, pg "
            f"{m['ppo_grad_norm']:.4g}, bc_nan_frac {m['bc_nan_frac']:.3f}"
            for m in ms)
        + f"; per epoch: context {ph.get('context', 0) / OF_TRAIN_EPOCHS:.3f} "
        f"s, rollout {ph.get('rollout', 0) / n * 1e3:.1f} ms per control "
        f"step, PPO {ph.get('ppo', 0) / OF_TRAIN_EPOCHS * 1e3:.1f} ms, BC "
        f"{ph.get('bc', 0) / OF_TRAIN_EPOCHS * 1e3:.1f} ms; launches "
        f"{ot['launches']} (expected {expect}); checkpoint params "
        f"{ot['layout']}, read back equal {ot['same']}; peak memory "
        f"{ot['peak']:.2f} GiB", tp)
    if solver_launches(ot["launches"]) != expect:
        fail(f"use_of training launches {ot['launches']} != {expect}")
    if len(ms) != OF_TRAIN_EPOCHS or not finite:
        fail(f"use_of training metrics missing or non-finite: {ms}")
    if not all(m["ppo_grad_norm"] > 0 and m["ratio_dev"] > 0 for m in ms):
        fail("dead PPO on the residual head: ppo_grad_norm or ratio_dev is 0")
    if any(m["bc_nan_frac"] != 0 for m in ms):
        fail("non-finite step-BC gradients in use_of (bc_nan_frac > 0)")
    if not ot["same"]:
        fail(f"the use_of checkpoint ({ot['layout']}) reads back different")
    for k in kernels:
        k["launches_by_path"]["use_of_train"] = ot["launches"].get(
            ar_rows.get(k["name"], ""), 0)
    del ot
    tp = time.perf_counter()
    frames = seeded_gray_clip(OF_FRAMES, 0)
    enc = video.FlowFeatureEncoder(device=device)
    feats = video.compute_of_features(frames, enc)
    of_ms = cuda_ms(lambda: video.compute_of_features(frames, enc), 5)
    ref = video.compute_of_features(frames, video.FlowFeatureEncoder(
        device="cpu", dtype=torch.float64))
    of_err = float((feats.double().cpu() - ref).abs().max())
    say("use_of", f"(d) compute_of_features on {OF_FRAMES} seeded uint8 "
        f"frames of 64 x 64 (3 levels, the encoder of of_encoder.pkl): "
        f"{of_ms:.2f} ms per clip, {of_ms / OF_FRAMES:.3f} ms per frame; "
        f"card f32 vs CPU f64 max abs err {of_err:.3g} (tol {OF_ATOL}), "
        f"max |feature| {float(ref.abs().max()):.3g}", tp)
    if tuple(feats.shape) != (OF_FRAMES, 512) or not bool(
            torch.isfinite(feats).all()):
        fail(f"flow features of shape {tuple(feats.shape)} or non-finite")
    if not of_err < OF_ATOL:
        fail(f"flow features card vs CPU max abs err {of_err:.3g}")

    # 13. uhc-modes: explicit residual forces, meta-PD, contacts off ------------
    tp = time.perf_counter()
    from kinpoly_tpu_torch.config.defaults import UHCConfig
    from kinpoly_tpu_torch.scripts import eval_pose_all
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "uhc_explicit.yml")
        with open(path, "w") as f:
            f.write(EXPLICIT_YML)
        ex_cfg = UHCConfig.load(path)
    uhc = UHCConfig.named("uhc")
    if ex_cfg != dataclasses.replace(
            uhc, name="uhc_explicit", residual_force_mode="explicit",
            residual_force_bodies="all", residual_force_torque=True,
            meta_pd=True, reward_id="local_rfc_explicit",
            reward_weights=dict(uhc.reward_weights, w_cp=0.1, k_cp=10.0)):
        fail(f"the explicit YAML reads back as {ex_cfg}")
    tr = run_training(device, MODES_ITERS, takes, cfg=ex_cfg)
    n = tr["steps"]
    expect = {"ltdl_factor": 30 * n, "ltdl_solve[R=1]": 15 * n,
              "ltdl_solve[R=55]": 15 * n, "pgs_solve": 15 * n}
    width = tr["agent"].env.action_dim
    same = checkpoint_round_trip(tr["agent"])
    m = tr["metrics"][-1]
    n_comp = sum(k.startswith("reward_components/") for k in m)
    say("uhc-modes", f"(a) train_uhc --cfg {ex_cfg.name}.yml (explicit "
        f"residual forces on {len(tr['agent'].env.model.ctrl.vf_bodies)} "
        f"bodies with torques, meta-PD, {ex_cfg.reward_id}): {width}-wide "
        f"policy, {TRAIN_ENVS} envs x {TRAIN_STEPS} steps x {MODES_ITERS} "
        f"iterations on {CLIPS24}: {tr['s_per_iter']:.2f} s per iteration, "
        f"rollout {tr['ms_per_step']:.1f} ms per control step (implicit "
        f"{ltdl_ms:.1f}), PPO update {tr['ppo_ms']:.1f} ms; last iteration "
        f"reward {m['reward_mean']:.4f} ({n_comp} components) policy_loss "
        f"{m['policy_loss']:.4g} value_loss {m['value_loss']:.4g}; launches "
        f"{tr['launches']} (expected {expect}); finite {tr['finite']}; "
        f"policy moved {tr['moved']:.3g}; checkpoint round trip identical "
        f"{same}", tp)
    if width != 315 or n_comp != 7:
        fail(f"explicit + meta-PD policy {width} wide with {n_comp} reward "
             f"components, expected 315 and 7")
    if solver_launches(tr["launches"]) != expect:
        fail(f"explicit + meta-PD training launches {tr['launches']} != {expect}")
    if [m["step"] for m in tr["metrics"]] != list(range(MODES_ITERS)):
        fail("explicit + meta-PD metrics stream not one line per iteration")
    if not tr["finite"]:
        fail("non-finite loss, reward or state in explicit + meta-PD training")
    if not tr["moved"] > 0:
        fail("the explicit + meta-PD policy did not change in training")
    if not same:
        fail("a reloaded explicit + meta-PD checkpoint gives other outputs")
    for k in kernels:
        k["launches_by_path"]["uhc_modes_train"] = tr["launches"].get(k["name"], 0)
    del tr

    tp = time.perf_counter()
    ex_card = eng.build_model(spec, ex_cfg.control_params(spec), device=device)
    ex_cpu = eng.build_model(spec, ex_cfg.control_params(spec), device="cpu",
                             dtype=torch.float64)
    xerr = control_step_parity(ex_card, ex_cpu, bank_qpos)
    say("uhc-modes", f"(b) one control step, 4 envs, explicit residual "
        f"forces and meta-PD ({ex_card.action_dim}-wide action), card f32 "
        f"vs CPU f64: max abs err {xerr:.3g} (tol {PARITY_ATOL})", tp)
    if not xerr < PARITY_ATOL:
        fail(f"explicit + meta-PD card vs CPU parity error {xerr:.3g}")
    del ex_card, ex_cpu

    tp = time.perf_counter()
    mov_card = eng.build_model(spec_o, uhc_control_params(spec_o), device=device,
                               with_objects=True, movable_objects=True)
    mov_cpu = eng.build_model(spec_o, uhc_control_params(spec_o), device="cpu",
                              dtype=torch.float64, with_objects=True,
                              movable_objects=True)
    off_ltdl = {"ltdl_factor": 30, "ltdl_solve[R=1]": 30}
    off = {}
    for mode, card_m, cpu_m, obj, want in (
            ("ltdl", model, cpu_model, None, off_ltdl),
            ("dense", dense_model, cpu_dense, None, {"chol_solve_only[R=1]": 30}),
            ("ltdl, movable objects", mov_card, mov_cpu,
             airborne_objects(len(spec_o.objects), 10), off_ltdl)):
        native.LAUNCHES.clear()
        err = control_step_parity(card_m, cpu_m, bank_qpos, with_contacts=False,
                                  obj=obj)
        torch.cuda.synchronize()
        off[mode] = (err, dict(native.LAUNCHES), want)
    ms_on, ops_on = host_ms_per_step(model, bank_qpos, TRAIN_ENVS,
                                     MODES_TIMED_STEPS, True)
    ms_off, ops_off = host_ms_per_step(model, bank_qpos, TRAIN_ENVS,
                                       MODES_TIMED_STEPS, False)
    say("uhc-modes", "(c) contacts off, one control step of 4 envs card f32 "
        "vs CPU f64: " + "; ".join(
            f"{k}: max abs err {e:.3g}, launches {got} (expected {w})"
            for k, (e, got, w) in off.items())
        + f" (tol {PARITY_ATOL}); host time per control step at {TRAIN_ENVS} "
        f"envs (LTDL): with contacts {ms_on:.1f} ms ({ops_on} aten ops "
        f"dispatched), without {ms_off:.1f} ms ({ops_off})", tp)
    for k, (e, got, w) in off.items():
        if solver_launches(got) != w:
            fail(f"contacts-off ({k}) launches {got} != {w}")
        if not e < PARITY_ATOL:
            fail(f"contacts-off ({k}) card vs CPU parity error {e:.3g}")
    for k in kernels:
        for path, key in (("uhc_contacts_off", "ltdl"),
                          ("uhc_contacts_off_dense", "dense")):
            k["launches_by_path"][path] = off[key][1].get(k["name"], 0)
    del mov_card, mov_cpu

    tp = time.perf_counter()
    kin_cfg = KinPolyConfig.named("kin_poly")
    with tempfile.TemporaryDirectory() as tmp:
        res_dir = os.path.join(kin_cfg.out_dir(tmp), "results")
        os.makedirs(res_dir)
        for i, rec in enumerate(ar_eval_records):
            with open(os.path.join(res_dir, f"{AR_ITER:04d}_wild_take{i}"
                                   f"_coverage_full.pkl"), "wb") as f:
                pickle.dump(rec, f)
        pose_mean = eval_pose_all.main(["--iter", str(AR_ITER), "--wild",
                                        "--out", tmp, "--device", "cuda"])
    ar_mean = ear.summary(ar_eval_rows, ar_eval_records)["mean"]
    if pose_mean is None:
        fail("eval_pose_all found no records")
    pose_err = max(abs(v - ar_mean[k]) for k, v in pose_mean.items())
    say("uhc-modes", f"(d) eval_pose_all on phase 10's {len(ar_eval_records)} "
        f"records: mean row " + " ".join(f"{k}:{v:.3f}" for k, v in
                                         pose_mean.items())
        + f"; max abs difference from phase 10's {pose_err:.3g} (tol "
        f"{POSE_ALL_ATOL})", tp)
    if not pose_err <= POSE_ALL_ATOL:
        fail(f"eval_pose_all's mean row differs from phase 10's by {pose_err:.3g}")

    # 14. data: grounding, AMASS, the viewer, the fine_tune rewards ----------
    data_phase(device, here, takes, ar_eval_records, kernels)

    # 15. zoo: LBS, retargeting, occupancy, the model zoo, TRPO and A2C ------
    zoo_phase(device, kernels)

    # 16. dp: data parallelism, two ranks on the card --------------------------
    dp_phase(here, takes, ltdl_ms, ar_rows, kernels)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
