"""Algorithm registry (``repro.rl.registry``): ``--algo`` names as data.

Each entry bundles an agent factory (env-spec aware, so action-space
mismatches fail loudly), the action space it needs, the PBT hyper-space
(paper §B.1 style ranges, copied from the JAX package) and the experience
kind: TD3, SAC and DQN (replay) and PPO (trajectory, either action space),
every algorithm of the JAX package.

SAC's space is the JAX package's verbatim, ``alpha`` included, so that the
hypers sampled from the same draws match; neither package's SAC update
reads ``alpha`` (the temperature is learned: ``log_alpha``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import HyperSpace


@dataclass(frozen=True)
class AlgoSpec:
    name: str
    make_agent: Callable            # (env_spec, **kw) -> ModuleAgent
    actions: str                    # "continuous" | "discrete" | "both"
    hyper_space: HyperSpace
    experience_kind: str


def _make_td3(spec, **kw):
    from repro_torch.pop import ModuleAgent
    from repro_torch.rl import td3
    return ModuleAgent(td3, spec.obs_dim, spec.act_dim, **kw)


def _make_sac(spec, **kw):
    from repro_torch.pop import ModuleAgent
    from repro_torch.rl import sac
    return ModuleAgent(sac, spec.obs_dim, spec.act_dim, **kw)


def _make_dqn(spec, **kw):
    from repro_torch.pop import ModuleAgent
    from repro_torch.rl import dqn
    return ModuleAgent(dqn, spec.obs_dim, spec.act_dim, **kw)


def _make_ppo(spec, **kw):
    from repro_torch.pop import PPOAgent
    return PPOAgent(spec.obs_dim, spec.act_dim, discrete=spec.discrete, **kw)


ALGOS = {
    "td3": AlgoSpec(
        "td3", _make_td3, "continuous",
        HyperSpace(log_uniform=(("actor_lr", 3e-5, 3e-3),
                                ("critic_lr", 3e-5, 3e-3)),
                   uniform=(("policy_freq", 0.2, 1.0), ("noise", 0.0, 1.0),
                            ("explore_noise", 0.0, 1.0),
                            ("discount", 0.9, 1.0))),
        "replay"),
    "sac": AlgoSpec(
        "sac", _make_sac, "continuous",
        HyperSpace(log_uniform=(("actor_lr", 3e-5, 3e-3),
                                ("critic_lr", 3e-5, 3e-3),
                                ("alpha", 0.01, 1.0)),
                   uniform=(("discount", 0.9, 1.0),)),
        "replay"),
    "dqn": AlgoSpec(
        "dqn", _make_dqn, "discrete",
        HyperSpace(log_uniform=(("lr", 1e-5, 1e-3),),
                   uniform=(("epsilon", 0.01, 0.3), ("discount", 0.9, 1.0))),
        "replay"),
    "ppo": AlgoSpec(
        "ppo", _make_ppo, "both",
        HyperSpace(log_uniform=(("lr", 1e-5, 1e-3),),
                   uniform=(("clip_eps", 0.1, 0.3),
                            ("entropy_coef", 0.0, 0.03),
                            ("gae_lambda", 0.9, 1.0),
                            ("discount", 0.9, 1.0))),
        "trajectory"),
}


def get_algo(name: str) -> AlgoSpec:
    spec = ALGOS.get(name)
    if spec is None:
        raise ValueError(f"unknown algorithm {name!r}; registered: "
                         f"{sorted(ALGOS)}")
    return spec


def make_agent(name: str, env_spec, **kw):
    """Build the registered agent for an env, validating the action space.
    ``kw`` goes to the agent (``device=`` among them)."""
    algo = get_algo(name)
    if algo.actions == "continuous" and env_spec.discrete:
        raise ValueError(f"{name} needs a continuous action space but env "
                         f"{env_spec.name!r} is discrete")
    if algo.actions == "discrete" and not env_spec.discrete:
        raise ValueError(f"{name} needs a discrete action space but "
                         f"env {env_spec.name!r} is continuous")
    return algo.make_agent(env_spec, **kw)
