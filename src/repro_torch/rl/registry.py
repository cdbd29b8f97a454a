"""Algorithm registry (``repro.rl.registry``): ``--algo`` names as data.

Only TD3 is ported; the JAX package's other algorithms raise "not ported
yet" rather than an unknown-name error, so a caller can tell the two
apart."""
from __future__ import annotations

_NOT_PORTED = ("sac", "dqn", "ppo")


def _make_td3(spec, **kw):
    from repro_torch.pop import ModuleAgent
    from repro_torch.rl import td3
    return ModuleAgent(td3, spec.obs_dim, spec.act_dim, **kw)


# name -> (agent factory, action space it needs)
ALGOS = {"td3": (_make_td3, "continuous")}


def make_agent(name: str, env_spec, **kw):
    """Build the registered agent for an env, validating the action space.
    ``kw`` goes to the agent (``device=`` among them)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ported: {sorted(ALGOS)})")
    if name not in ALGOS:
        raise ValueError(f"unknown algorithm {name!r}; registered: "
                         f"{sorted(ALGOS)}")
    factory, actions = ALGOS[name]
    if actions == "continuous" and env_spec.discrete:
        raise ValueError(f"{name} needs a continuous action space but env "
                         f"{env_spec.name!r} is discrete")
    return factory(env_spec, **kw)
