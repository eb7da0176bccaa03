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
              at the objects slice's shapes (R = 49, 79; C = 72, 108)
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
Then a JSON line with every kernel's numbers, the card's nvidia-smi line,
and as the last line {"ok": true, "device": {...}}. Any failure exits
non-zero before that line; a watchdog ends the run past 10 minutes.
"""

from __future__ import annotations

import json
import os
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


def control_step_parity(card_model, cpu_model, bank_qpos) -> float:
    """Max abs difference of qpos/qvel after one control step of 4 envs,
    card model against CPU model, from seeded states near the clips."""
    import torch
    from kinpoly_tpu_torch.physics import engine as eng

    rng = np.random.RandomState(7)
    q0 = bank_qpos[:4, 0].double().cpu().numpy()
    qpos = q0.copy()
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (4, 69))
    qvel = rng.normal(0, 0.3, (4, 75))
    action = rng.normal(0, 0.2, (4, 75))
    base_rot = np.asarray([0.7071, 0.7071, 0.0, 0.0], np.float32)
    outs = []
    for m in (card_model, cpu_model):
        t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
        s = eng.control_step(m, eng.SimState(t(qpos), t(qvel)), t(action),
                             t(q0[:, 7:]), t(base_rot))
        outs.append([x.double().cpu() for x in s if x is not None])
    return max(float((a - b).abs().max()) for a, b in zip(*outs))


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


def ar_step_parity(takes, device, here: str, box_on_the_hand: bool):
    """One AR env step of one env per take, card (float32, kernels) against
    the CPU float64 plain path, from the CPU's context bank (cast to the
    card) and the CPU policy's mean action: max abs difference of humanoid
    and object state, and of the reward and its components. With
    `box_on_the_hand` the box is moved onto each env's right hand at the
    reset pose."""
    import torch
    from kinpoly_tpu_torch.scripts import eval_ar_policy as ear

    kw = dict(uhc_checkpoint=os.path.join(here, UHC_CKPT),
              out_root=os.path.join(here, AR_OUT))
    evs = [ear.build_eval(takes, AR_ITER, device, **kw),
           ear.build_eval(takes, AR_ITER, "cpu", torch.float64, **kw)]
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
                 **model_kw) -> dict:
    """`iters` iterations of train_uhc's loop for the uhc.yml agent at
    TRAIN_ENVS envs and TRAIN_STEPS control steps over `takes`, through the
    kernels of the configuration that `model_kw` selects; launch counters
    set to 0 just before and read just after; the metrics stream written
    to a temporary directory and read back. Returns the launches, the
    timings, the stream's records and the agent."""
    import torch
    from kinpoly_tpu_torch import native
    from kinpoly_tpu_torch.config.defaults import UHCConfig
    from kinpoly_tpu_torch.rl import ppo
    from kinpoly_tpu_torch.scripts.train_uhc import build_trainer, train
    from kinpoly_tpu_torch.utils.logger import create_logger
    from kinpoly_tpu_torch.utils.metrics_log import MetricsLogger

    cfg = UHCConfig()
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
                m["fail_frac"]] + [m[f"reward_components/{i}"] for i in range(5)]
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
    if launches != expect:
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
    if tr["launches"] != expect:
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
    if tr["launches"] != expect:
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
    d_ms = sum(c * ms_of[name] for name, c in tr["launches"].items()) / n
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
    ar_ms = run_s / AR_STEPS * 1e3
    say("ar", f"{ev.n_takes} wild takes of {WILD} (longest "
        f"{ev.batch.qpos.shape[1]} frames), context {ctx_s:.2f} s; {AR_STEPS} "
        f"control steps: {ar_ms:.1f} ms per control step, launches {launches} "
        f"(expected {expect}), finite {finite}; success "
        f"{summ['succ']}, mean tracked {summ['mean']['percent']:.3f}; MEAN "
        + " ".join(f"{k}:{v:.3f}" for k, v in summ["mean"].items()), tp)
    if launches != expect:
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
               "pgs_solve[C=72]": "pgs_solve"}
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
    if ce["launches"] != expect:
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

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
