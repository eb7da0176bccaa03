"""UHC configuration: the repo's UHC configs (``kinpoly_tpu/config/yaml/
uhc.yml`` and ``uhc_quatv2.yml``) as a dataclass with the adaptive schedules
and the training config derived from them (port of
``kinpoly_tpu/config/config.py`` ``UHCConfig``), the kinematic policy's
(``kin_poly.yml``, ``KinPolyConfig``), and the per-joint stable-PD table
(port of ``kinpoly_tpu/config/defaults.py``).

The defaults below are copied from uhc.yml and kin_poly.yml, and
``NAMED_CONFIGS``/``NAMED_KIN_CONFIGS`` hold what each other config
changes (the port reads no YAML); a test holds each against its YAML as
the JAX package parses it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from kinpoly_tpu_torch.physics.engine import ControlParams

# (k_p, k_d, torque limit) per 3-hinge body, identical for its z/y/x hinges
_BODY_PD = {
    "L_Hip": (500.0, 50.0, 200.0),
    "L_Knee": (500.0, 50.0, 150.0),
    "L_Ankle": (400.0, 40.0, 100.0),
    "L_Toe": (200.0, 20.0, 100.0),
    "R_Hip": (500.0, 50.0, 200.0),
    "R_Knee": (500.0, 50.0, 150.0),
    "R_Ankle": (400.0, 40.0, 100.0),
    "R_Toe": (200.0, 20.0, 100.0),
    "Torso": (1000.0, 100.0, 200.0),
    "Spine": (1000.0, 100.0, 200.0),
    "Chest": (1000.0, 100.0, 200.0),
    "Neck": (100.0, 10.0, 50.0),
    "Head": (100.0, 10.0, 50.0),
    "L_Thorax": (400.0, 40.0, 100.0),
    "L_Shoulder": (400.0, 40.0, 100.0),
    "L_Elbow": (300.0, 30.0, 60.0),
    "L_Wrist": (100.0, 10.0, 50.0),
    "L_Hand": (100.0, 10.0, 50.0),
    "R_Thorax": (400.0, 40.0, 100.0),
    "R_Shoulder": (400.0, 40.0, 100.0),
    "R_Elbow": (300.0, 30.0, 60.0),
    "R_Wrist": (100.0, 10.0, 50.0),
    "R_Hand": (100.0, 10.0, 50.0),
}

# per-body weights of the imitation body-difference distance
BODY_DIFF_WEIGHTS = {"L_Toe": 0.0, "R_Toe": 0.0, "L_Hand": 0.0, "R_Hand": 0.0}


def uhc_control_params(spec, rfc_scale: float = 100.0,
                       rfc_lim: float = float("inf")) -> ControlParams:
    """ControlParams from the PD table (implicit RFC, action_v 1)."""
    jkp, jkd, tl = [], [], []
    for name in spec.body_names[1:]:
        kp, kd, lim = _BODY_PD[name]
        jkp += [kp] * 3
        jkd += [kd] * 3
        tl += [lim] * 3
    n = len(jkp)
    return ControlParams(jkp=np.asarray(jkp), jkd=np.asarray(jkd),
                         a_ref=np.zeros(n), a_scale=np.ones(n),
                         torque_lim=np.asarray(tl), rfc_scale=rfc_scale,
                         rfc_lim=rfc_lim, action_v=1)


def body_diff_weights(spec) -> np.ndarray:
    """(24,) per-body weight of the termination distance (Pelvis 1)."""
    w = np.asarray([BODY_DIFF_WEIGHTS.get(n, 1.0) for n in spec.body_names])
    w[0] = 1.0
    return w


def b_diff_weights_pose(spec) -> np.ndarray:
    """(23,) non-root body weights of the reward's pose term."""
    return body_diff_weights(spec)[1:]


_REWARD_WEIGHTS = dict(w_p=0.3, w_v=0.1, w_e=0.45, w_c=0.1, w_vf=0.05,
                       k_p=2.0, k_v=0.005, k_e=5.0, k_c=100.0, k_vf=1.0)


# what each named config changes from uhc.yml
NAMED_CONFIGS = {"uhc": {}, "uhc_quatv2": {"reward_id": "quat_v2"}}


@dataclass(frozen=True)
class UHCConfig:
    """A UHC training configuration, field for field, and its ``name``
    (the YAML's; it names the output directory). ``UHCConfig.named(name)``
    gives one of ``NAMED_CONFIGS``; ``UHCConfig()`` is uhc.yml."""
    name: str = "uhc"
    gamma: float = 0.95
    tau: float = 0.95
    policy_htype: str = "relu"
    policy_hsize: tuple = (512, 256)
    policy_lr: float = 5.0e-5
    value_htype: str = "relu"
    value_hsize: tuple = (512, 256)
    value_lr: float = 3.0e-4
    clip_epsilon: float = 0.2
    min_batch_size: int = 50000
    mini_batch_size: int = 32768
    num_optim_epoch: int = 10
    log_std: float = -2.3
    fix_std: bool = True
    max_iter_num: int = 30000
    seed: int = 1
    save_model_interval: int = 100
    reward_id: str = "world_rfc_implicit"
    actor_type: str = "mcp"
    num_primitive: int = 8
    action_v: int = 1
    obs_v: int = 1
    reactive_v: int = 1
    reactive_rate: float = 0.3
    sampling_temp: float = 2
    env_term_body: str = "body"
    env_episode_len: int = 100000
    obs_coord: str = "root"
    obs_vel: str = "full"
    residual_force: bool = True
    residual_force_scale: float = 100.0
    residual_force_lim: float = 100.0
    residual_force_mode: str = "implicit"
    base_rot: tuple = (0.7071, 0.7071, 0.0, 0.0)
    reward_weights: dict = field(default_factory=lambda: dict(_REWARD_WEIGHTS))
    n_envs: int = 1024
    rollout_steps: int = 48

    @classmethod
    def named(cls, name: str) -> "UHCConfig":
        if name not in NAMED_CONFIGS:
            raise ValueError(f"unknown UHC config {name!r}; available: "
                             f"{sorted(NAMED_CONFIGS)}")
        return cls(name=name, **NAMED_CONFIGS[name])

    def out_dir(self, out_root: str = "results") -> str:
        """The run's directory (``log.txt``)."""
        return os.path.join(out_root, "motion_im", self.name)

    def model_dir(self, out_root: str = "results") -> str:
        """Where the trainer writes ``iter_*.p`` checkpoints and its
        metrics stream."""
        return os.path.join(self.out_dir(out_root), "models")

    # adaptive schedules (reference copycat_config.py:149-166): uhc.yml sets
    # none, so each is the one-point schedule the JAX config defaults to
    @property
    def adp_iter_cp(self) -> np.ndarray:
        return np.asarray([0])

    @property
    def adp_noise_rate_cp(self) -> np.ndarray:
        return np.asarray([1.0])

    @property
    def adp_log_std_cp(self) -> np.ndarray:
        return np.asarray([self.log_std])

    @property
    def adp_policy_lr_cp(self) -> np.ndarray:
        return np.asarray([self.policy_lr])

    def adaptive_params(self, i_iter: int) -> dict:
        """Linear interpolation between the schedules' checkpoints
        (copycat_config.update_adaptive_params)."""
        cp = self.adp_iter_cp
        idx = int(np.searchsorted(cp, i_iter, side="right") - 1)
        nxt = min(idx + 1, len(cp) - 1)
        t = 0.0 if cp[nxt] == cp[idx] else (i_iter - cp[idx]) / (cp[nxt] - cp[idx])

        def lerp(arr):
            return float(arr[idx] * (1 - t) + arr[nxt] * t)

        return dict(noise_rate=lerp(self.adp_noise_rate_cp),
                    log_std=lerp(self.adp_log_std_cp),
                    policy_lr=lerp(self.adp_policy_lr_cp))

    def env_config(self):
        from kinpoly_tpu_torch.envs.humanoid_im import EnvConfig

        return EnvConfig(
            obs_v=self.obs_v, obs_coord=self.obs_coord, obs_vel=self.obs_vel,
            env_term_body=self.env_term_body,
            env_episode_len=self.env_episode_len,
            reactive_v=self.reactive_v, reactive_rate=self.reactive_rate,
            base_rot=self.base_rot, reward_id=self.reward_id,
            **self.reward_weights)

    def train_config(self):
        """The trainer's config (the fields the JAX ``train_config`` sets;
        noise rate, success EWMA rate and gradient clip keep the
        trainer's defaults)."""
        from kinpoly_tpu_torch.rl.agent_uhc import UHCTrainConfig

        return UHCTrainConfig(
            n_envs=self.n_envs, rollout_steps=self.rollout_steps,
            gamma=self.gamma, tau=self.tau, clip_epsilon=self.clip_epsilon,
            num_optim_epoch=self.num_optim_epoch,
            mini_batch_size=self.mini_batch_size,
            policy_lr=self.policy_lr, value_lr=self.value_lr,
            log_std=self.log_std, fix_std=self.fix_std,
            actor_type=self.actor_type, num_primitive=self.num_primitive,
            policy_hsize=self.policy_hsize, value_hsize=self.value_hsize,
            policy_htype=self.policy_htype,
            sampling_temp=self.sampling_temp, seed=self.seed,
            save_model_interval=self.save_model_interval)


_KIN_MODEL_SPECS = dict(model_v=1, rnn_hdim=1024, mlp_hsize=[1024, 512, 256],
                        mlp_htype="relu", w_rp=50.0, w_rr=50.0, w_p=1.0,
                        w_v=1.0, w_ee=10.0, w_op=1.0, w_or=10.0)
_KIN_POLICY_SPECS = dict(
    policy_v=1, log_std=-3.2, fix_std=True, gamma=0.95, tau=0.95,
    policy_lr=1.0e-5, value_lr=3.0e-4, clip_epsilon=0.2,
    min_batch_size=10000, reward_id="dynamic_supervision_v1",
    max_iter_num=20000, save_model_interval=50, rl_update=True,
    init_update=False, step_update=True, full_update=False,
    sampling_temp=0.3, sampling_freq=0.5, num_init_update=3,
    num_step_update=20, num_optim_epoch=10, body_diff_thresh=10.0,
    body_diff_gt_thresh=12.0,
    reward_weights=dict(w_hp=0.15, w_hq=0.15, w_p=0.2, w_jp=0.2,
                        w_act_p=0.2, w_act_v=0.1, k_hp=45, k_hq=45, k_p=50,
                        k_jp=50, k_act_p=5, k_act_v=0.005))


_KIN_MODEL_SPECS_NO_W = {k: _KIN_MODEL_SPECS[k]
                         for k in ("model_v", "rnn_hdim", "mlp_hsize", "mlp_htype")}

# what each named kinematic-policy config changes from kin_poly.yml
NAMED_KIN_CONFIGS = {
    "kin_poly": {},
    # supervised only: no dynamics regulation, the warm start's updates
    "kin_only": dict(policy_specs=dict(policy_v=1, rl_update=False,
                                       step_update=False, init_update=True,
                                       full_update=True)),
    # no action one-hot conditioning
    "kin_poly_wo_action": dict(
        use_action=False, model_specs=_KIN_MODEL_SPECS_NO_W,
        policy_specs=dict(policy_v=1, rl_update=True, step_update=True)),
}
# configs of the JAX package that the port cannot run yet, and why
UNPORTED_KIN_CONFIGS = {
    "use_of": "policy_v 2 (the residual head ActionDeltaNet) and the "
              "optical-flow features (data/video.py, models/aux_nets.py)",
}


@dataclass(frozen=True)
class KinPolyConfig:
    """The kinematic policy's configuration, kin_poly.yml field for field
    (``model_specs``/``policy_specs`` as the YAML's dicts), and its
    ``name`` (the output directory's). ``KinPolyConfig.named(name)`` gives
    one of ``NAMED_KIN_CONFIGS``."""
    name: str = "kin_poly"
    seed: int = 4
    fr_num: int = 100
    use_of: bool = False
    use_head: bool = True
    use_action: bool = True
    use_vel: bool = False
    use_context: bool = False
    use_obj: bool = True
    smooth: bool = True
    has_z: bool = True
    add_noise: bool = True
    noise_std: float = 0.01
    lr: float = 5.0e-4
    num_epoch: int = 10000
    batch_size: int = 256
    model_specs: dict = field(default_factory=lambda: dict(_KIN_MODEL_SPECS))
    policy_specs: dict = field(default_factory=lambda: dict(_KIN_POLICY_SPECS))
    n_envs: int = 64
    rollout_steps: int = 156

    @classmethod
    def named(cls, name: str) -> "KinPolyConfig":
        if name in UNPORTED_KIN_CONFIGS:
            raise ValueError(f"config {name!r} is not ported: it needs "
                             f"{UNPORTED_KIN_CONFIGS[name]}")
        if name not in NAMED_KIN_CONFIGS:
            raise ValueError(f"unknown kinematic-policy config {name!r}; "
                             f"available: {sorted(NAMED_KIN_CONFIGS)}")
        return cls(name=name, **{k: dict(v) if isinstance(v, dict) else v
                                 for k, v in NAMED_KIN_CONFIGS[name].items()})

    def out_dir(self, out_root: str = "results") -> str:
        return os.path.join(out_root, "statear", self.name)

    def model_dir(self, out_root: str = "results") -> str:
        """Where the AR trainer's ``iter_*.p`` checkpoints are."""
        return os.path.join(self.out_dir(out_root), "models")

    def traj_ar_config(self):
        from kinpoly_tpu_torch.models.traj_ar import TrajARConfig

        ms = self.model_specs
        return TrajARConfig(
            use_of=self.use_of, use_head=self.use_head,
            use_action=self.use_action, use_vel=self.use_vel,
            use_context=self.use_context, has_z=self.has_z,
            pose_delta=ms.get("pose_delta", False),
            add_noise=self.add_noise, noise_std=self.noise_std,
            model_v=ms.get("model_v", 1), rnn_hdim=ms.get("rnn_hdim", 1024),
            of_dim=ms.get("cnn_fdim", 512),
            mlp_hsize=tuple(ms.get("mlp_hsize", [1024, 512, 256])),
            mlp_htype=ms.get("mlp_htype", "relu"),
            w_rp=ms.get("w_rp", 50.0), w_rr=ms.get("w_rr", 50.0),
            w_p=ms.get("w_p", 1.0), w_v=ms.get("w_v", 1.0),
            w_ee=ms.get("w_ee", 10.0), w_op=ms.get("w_op", 1.0),
            w_or=ms.get("w_or", 10.0))

    def reward_weights(self):
        from kinpoly_tpu_torch.envs.humanoid_ar import ARRewardWeights

        rw = self.policy_specs.get("reward_weights", {})
        return ARRewardWeights(
            reward_id=self.policy_specs.get("reward_id",
                                            "dynamic_supervision_v1"),
            w_hp=rw.get("w_hp", 0.15), w_hq=rw.get("w_hq", 0.15),
            w_p=rw.get("w_p", 0.2), w_jp=rw.get("w_jp", 0.2),
            w_act_p=rw.get("w_act_p", 0.2), w_act_v=rw.get("w_act_v", 0.1),
            w_hv=rw.get("w_hv", 0.05),
            k_hp=rw.get("k_hp", 45.0), k_hq=rw.get("k_hq", 45.0),
            k_p=rw.get("k_p", 50.0), k_jp=rw.get("k_jp", 50.0),
            k_act_p=rw.get("k_act_p", 5.0), k_act_v=rw.get("k_act_v", 0.005),
            k_rp=rw.get("k_rp", 0.1), k_rq=rw.get("k_rq", 0.1))

    def train_config(self):
        """The AR trainer's config (``rl/agent_ar.ARTrainConfig``), the
        fields the JAX ``train_config`` sets."""
        from kinpoly_tpu_torch.rl.agent_ar import ARTrainConfig

        ps = self.policy_specs
        return ARTrainConfig(
            lr=self.lr, batch_size=self.batch_size, fr_num=self.fr_num,
            policy_lr=ps.get("policy_lr", 1e-5),
            value_lr=ps.get("value_lr", 3e-4),
            clip_epsilon=ps.get("clip_epsilon", 0.2),
            gamma=ps.get("gamma", 0.95), tau=ps.get("tau", 0.95),
            num_optim_epoch=ps.get("num_optim_epoch", 10),
            num_step_update=ps.get("num_step_update", 20),
            num_init_update=ps.get("num_init_update", 3),
            log_std=ps.get("log_std", -3.2),
            n_envs=self.n_envs, rollout_steps=self.rollout_steps,
            sampling_temp=ps.get("sampling_temp", 0.3),
            sampling_freq=ps.get("sampling_freq", 0.5),
            seed=self.seed,
            save_model_interval=ps.get("save_model_interval", 50),
            rl_update=ps.get("rl_update", True),
            step_update=ps.get("step_update", True),
            step_update_dyna=ps.get("step_update_dyna", False),
            init_update=ps.get("init_update", False),
            full_update=ps.get("full_update", False),
            joint_controller=ps.get("joint_controller", False),
            cc_lr=ps.get("cc_lr", 1e-5))
