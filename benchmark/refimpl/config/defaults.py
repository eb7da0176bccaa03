"""The UHC configuration as a dataclass, with the control, env and training
configs derived from it, and the per-joint stable-PD table. The harness
builds it from the values a configuration file of ``benchmark/configs``
holds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from refimpl.physics.engine import ControlParams

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


def uhc_control_params(spec, rfc_scale: float = 100.0, meta_pd: bool = False,
                       rfc_mode: str = "implicit",
                       rfc_lim: float = float("inf"),
                       vf_bodies: str | tuple = "all",
                       residual_force_torque: bool = True) -> ControlParams:
    """ControlParams from the PD table (action_v 1). Explicit residual
    forces act on `vf_bodies`: "all" (every body, in spec order) or body
    names."""
    jkp, jkd, tl = [], [], []
    for name in spec.body_names[1:]:
        kp, kd, lim = _BODY_PD[name]
        jkp += [kp] * 3
        jkd += [kd] * 3
        tl += [lim] * 3
    n = len(jkp)
    vf_idx = ()
    if rfc_mode == "explicit":
        vf_idx = (tuple(range(len(spec.body_names))) if vf_bodies == "all"
                  else tuple(spec.body_index(b) for b in vf_bodies))
    return ControlParams(jkp=np.asarray(jkp), jkd=np.asarray(jkd),
                         a_ref=np.zeros(n), a_scale=np.ones(n),
                         torque_lim=np.asarray(tl), rfc_scale=rfc_scale,
                         rfc_lim=rfc_lim, action_v=1, meta_pd=meta_pd,
                         rfc_mode=rfc_mode, vf_bodies=vf_idx,
                         residual_force_torque=residual_force_torque)


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


# the reward weights the env config takes from a YAML's reward_weights
# (the JAX env_config's list); others are ignored, as there
_ENV_REWARD_KEYS = ("w_p", "w_v", "w_e", "w_c", "w_vf", "k_p", "k_v", "k_e",
                    "k_c", "k_vf", "w_rp", "w_rv", "k_rh", "k_rq", "k_rl",
                    "k_ra", "w_cp", "k_cp", "w_wp", "w_j", "k_wp", "k_j")


@dataclass(frozen=True)
class UHCConfig:
    """A UHC training configuration, field for field, and its ``name``
    (the YAML's basename; it names the output directory).
    ``UHCConfig.named(name)`` gives one of ``NAMED_CONFIGS``,
    ``UHCConfig.from_yaml(path)`` reads a YAML, ``UHCConfig.load`` takes
    either; ``UHCConfig()`` is uhc.yml. Fields uhc.yml does not set keep
    the JAX config's defaults; ``adp_log_std_cp``/``adp_policy_lr_cp``
    None mean the one-point schedule at ``log_std``/``policy_lr``."""
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
    # not set by uhc.yml: the JAX config's defaults
    residual_force_bodies: str | tuple = "all"
    residual_force_torque: bool = True
    meta_pd: bool = False
    env_expert_trail_steps: int = 0
    env_init_noise: float = 0.0
    # adaptive schedules (reference copycat_config.py:149-166)
    adp_iter_cp: tuple = (0,)
    adp_noise_rate_cp: tuple = (1.0,)
    adp_log_std_cp: tuple | None = None
    adp_policy_lr_cp: tuple | None = None

    def control_params(self, spec) -> ControlParams:
        """The engine's control parameters with every residual-force knob
        of the config: scale (0 without ``residual_force``), the limit,
        mode, bodies and torque, and meta-PD (the JAX trainer's)."""
        vb = self.residual_force_bodies
        return uhc_control_params(
            spec,
            rfc_scale=self.residual_force_scale if self.residual_force else 0.0,
            meta_pd=self.meta_pd, rfc_mode=self.residual_force_mode,
            rfc_lim=self.residual_force_lim,
            vf_bodies=vb if vb == "all" else tuple(vb),
            residual_force_torque=self.residual_force_torque)

    def env_config(self):
        from refimpl.envs.humanoid_im import EnvConfig

        rw = self.reward_weights
        return EnvConfig(
            obs_v=self.obs_v, obs_coord=self.obs_coord, obs_vel=self.obs_vel,
            env_term_body=self.env_term_body,
            env_episode_len=self.env_episode_len,
            env_expert_trail_steps=self.env_expert_trail_steps,
            env_init_noise=self.env_init_noise,
            reactive_v=self.reactive_v, reactive_rate=self.reactive_rate,
            base_rot=self.base_rot, reward_id=self.reward_id,
            **{k: rw[k] for k in _ENV_REWARD_KEYS if k in rw})

    def train_config(self):
        """The trainer's config (the fields the JAX ``train_config`` sets;
        noise rate, success EWMA rate and gradient clip keep the
        trainer's defaults)."""
        from refimpl.rl.agent_uhc import UHCTrainConfig

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
