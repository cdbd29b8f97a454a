"""SAC (Haarnoja et al., 2018) with a learned temperature, functional and
population-batched (``repro.rl.sac``).

The hyperparameters PBT tunes (§B.1) are per-member inputs (the
``hypers`` dict of ``(N,)`` vectors): actor_lr, critic_lr, alpha_lr,
target_entropy_scale, reward_scale, discount. A step updates the twin
critic (its target built with the old temperature), then the actor (its
loss reads the updated critic), then ``log_alpha`` (its loss reads the
actor loss's log-probs, detached), then the target critic.

The state holds no PRNG key: a step takes two standard normal draws of
the action's shape, the next action's in the critic target and the
action's in the actor loss, from a ``torch.Generator`` given per call or
injected as ``noise`` (stacked: ``(2, B, act)`` for one member, ``(N, 2,
B, act)`` for the population).

Two updates, as in the JAX package: :func:`update`, one member's step on
plain dense layers and the stock :func:`repro_torch.optim.adam` (the
``sequential`` backend), and :func:`make_population_update`, every member
at once through the ``pop_matmul`` and ``pop_adam`` kernels (the
``vectorized`` backend).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.distributed import member_draw
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.rl import networks as nets
from repro_torch.rl.td3 import _grad_tree, _soft_update, _with_grad
from repro_torch.tree import tree_map

DEFAULT_HYPERS = {
    "actor_lr": 3e-4, "critic_lr": 3e-4, "alpha_lr": 3e-4,
    "target_entropy_scale": 1.0, "reward_scale": 1.0, "discount": 0.99,
}
TAU = 0.005

_opt_init, _opt_update = adam(3e-4)


class SACState(NamedTuple):
    actor: Any
    critic: Any
    target_critic: Any
    log_alpha: torch.Tensor
    actor_opt: Any
    critic_opt: Any
    alpha_opt: Any
    step: torch.Tensor


def actor_init(generator, obs_dim: int, act_dim: int, hidden=nets.HIDDEN, *,
               device="cpu"):
    """One member's gaussian actor (all that serving needs)."""
    return nets.gaussian_actor_init(generator, obs_dim, act_dim,
                                    hidden=hidden, device=device)


def init(generator, obs_dim: int, act_dim: int, hidden=nets.HIDDEN, *,
         device="cpu") -> SACState:
    actor = actor_init(generator, obs_dim, act_dim, hidden=hidden,
                       device=device)
    critic = nets.critic_init(generator, obs_dim, act_dim, hidden=hidden,
                              device=device)
    log_alpha = torch.zeros((), dtype=torch.float32, device=device)
    return SACState(
        actor=actor, critic=critic,
        target_critic=tree_map(torch.clone, critic), log_alpha=log_alpha,
        actor_opt=_opt_init(actor), critic_opt=_opt_init(critic),
        alpha_opt=_opt_init(log_alpha),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _act(mean, log_std, generator):
    if generator is None:
        return torch.tanh(mean)
    eps = member_draw(torch.randn, mean.shape, generator).to(mean.device)
    return nets.sample_squashed(eps, mean, log_std)[0]


def policy(actor_params, obs, generator=None):
    """The tanh of the gaussian's mean; with a generator, a squashed
    sample."""
    return _act(*nets.gaussian_actor_apply(actor_params, obs), generator)


def pop_policy(actors, obs, generator=None):
    """Population-level :func:`policy`: member-stacked actors on (N,B,obs)
    observations, each linear one ``pop_matmul``."""
    return _act(*nets.pop_gaussian_actor_apply(actors, obs), generator)


def _draw(generator, action, lead=()):
    """The step's two standard normal draws, stacked after ``lead``."""
    return member_draw(torch.randn,
                       lead + (2,) + tuple(action.shape[len(lead):]),
                       generator)


def update(state: SACState, batch, hypers=None, generator=None, *,
           noise=None):
    """One member's SAC step: batch leaves (B, ...), hypers a dict of
    scalars (or None), ``noise`` the injected (2, B, act) standard normal
    draws (drawn from ``generator`` otherwise). Returns ``(state,
    {"critic_loss", "actor_loss", "alpha"})``."""
    h = dict(DEFAULT_HYPERS)
    if hypers:
        h.update(hypers)
    if noise is None:
        noise = _draw(generator, batch["action"])
    target_entropy = -h["target_entropy_scale"] * batch["action"].shape[-1]
    alpha = torch.exp(state.log_alpha)

    with torch.no_grad():
        mean, log_std = nets.gaussian_actor_apply(state.actor,
                                                  batch["next_obs"])
        next_a, next_logp = nets.sample_squashed(noise[0], mean, log_std)
        tq1, tq2 = nets.critic_apply(state.target_critic, batch["next_obs"],
                                     next_a)
        target = batch["reward"] * h["reward_scale"] + h["discount"] * (
            1 - batch["done"]) * (torch.minimum(tq1, tq2) - alpha * next_logp)
    critic_in = _with_grad(state.critic)
    q1, q2 = nets.critic_apply(critic_in, batch["obs"], batch["action"])
    closs = ((q1 - target) ** 2).mean() + ((q2 - target) ** 2).mean()
    cupd, critic_opt = _opt_update(_grad_tree(closs, critic_in),
                                   state.critic_opt,
                                   lr_override=h["critic_lr"])
    critic = apply_updates(state.critic, cupd)

    actor_in = _with_grad(state.actor)
    a, logp = nets.sample_squashed(
        noise[1], *nets.gaussian_actor_apply(actor_in, batch["obs"]))
    q1, q2 = nets.critic_apply(critic, batch["obs"], a)
    aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
    aupd, actor_opt = _opt_update(_grad_tree(aloss, actor_in),
                                  state.actor_opt, lr_override=h["actor_lr"])
    actor = apply_updates(state.actor, aupd)

    # d/d log_alpha of -mean(exp(log_alpha) c) is that loss itself
    lgrad = -(alpha * (logp.detach() + target_entropy)).mean()
    lupd, alpha_opt = _opt_update(lgrad, state.alpha_opt,
                                  lr_override=h["alpha_lr"])
    log_alpha = state.log_alpha + lupd

    new_state = SACState(
        actor=actor, critic=critic,
        target_critic=_soft_update(state.target_critic, critic, TAU),
        log_alpha=log_alpha, actor_opt=actor_opt, critic_opt=critic_opt,
        alpha_opt=alpha_opt, step=state.step + 1)
    return new_state, {"critic_loss": closs.detach(),
                       "actor_loss": aloss.detach(),
                       "alpha": torch.exp(log_alpha)}


def make_population_update(*, fused_linear: bool = False, fused=None):
    """Population-level SAC update over the member-stacked state.

    ``fused_linear`` routes every population-batched linear through the
    ``pop_matmul`` wrapper (the CUDA kernel on CUDA tensors), otherwise
    through the plain einsum version; ``fused`` goes to
    ``population_adam`` (None: the ``pop_adam`` wrapper, False: its plain
    version).

    Returns ``update(state, batch, hypers, generator, *, noise=None) ->
    (state, metrics)``; ``batch`` leaves are (N, B, ...), ``hypers`` a dict
    of (N,) vectors or None, ``noise`` the injected (N, 2, B, act) draws.
    Metrics are per member, each (N,).

    One step makes 24 ``pop_matmul`` forward calls (the critic target's
    actor 3 and target critic 6, the critic 6, the actor loss's actor 3
    and critic 6) and 3 ``pop_adam`` calls (critic, actor, and
    ``log_alpha``, one parameter a member).
    """
    from repro_torch.optim.pop_adam import population_adam
    from repro_torch.rl.fused import pop_hypers
    _, pa = population_adam(3e-4, fused=fused)
    lin = None if fused_linear else False
    col = lambda v: v[:, None]

    def update(state: SACState, batch, hypers=None, generator=None, *,
               noise=None):
        n = state.step.shape[0]
        h = pop_hypers(DEFAULT_HYPERS, hypers, n, state.step.device)
        if noise is None:
            noise = _draw(generator, batch["action"], (n,))
        target_entropy = -h["target_entropy_scale"] * \
            batch["action"].shape[-1]                             # (N,)
        alpha = torch.exp(state.log_alpha)                        # (N,)

        with torch.no_grad():
            mean, log_std = nets.pop_gaussian_actor_apply(
                state.actor, batch["next_obs"], fused=lin)
            next_a, next_logp = nets.sample_squashed(noise[:, 0], mean,
                                                     log_std)
            tq1, tq2 = nets.pop_critic_apply(
                state.target_critic, batch["next_obs"], next_a, fused=lin)
            target = batch["reward"] * col(h["reward_scale"]) + \
                col(h["discount"]) * (1 - batch["done"]) * (
                    torch.minimum(tq1, tq2) - col(alpha) * next_logp)
        # members are independent: the gradient of the summed per-member
        # losses IS the stacked per-member gradients
        critic_in = _with_grad(state.critic)
        q1, q2 = nets.pop_critic_apply(critic_in, batch["obs"],
                                       batch["action"], fused=lin)
        closs = ((q1 - target) ** 2).mean(1) + ((q2 - target) ** 2).mean(1)
        critic, critic_opt = pa(state.critic,
                                _grad_tree(closs.sum(), critic_in),
                                state.critic_opt, lr_override=h["critic_lr"])

        # the actor loss reads the UPDATED critic and differentiates the
        # actor only
        actor_in = _with_grad(state.actor)
        a, logp = nets.sample_squashed(
            noise[:, 1], *nets.pop_gaussian_actor_apply(
                actor_in, batch["obs"], fused=lin))
        q1, q2 = nets.pop_critic_apply(critic, batch["obs"], a, fused=lin)
        aloss = (col(alpha) * logp - torch.minimum(q1, q2)).mean(1)
        actor, actor_opt = pa(state.actor, _grad_tree(aloss.sum(), actor_in),
                              state.actor_opt, lr_override=h["actor_lr"])

        # each member's d/d log_alpha of -mean(exp(log_alpha) c) is that
        # loss itself
        lgrad = -(col(alpha) * (logp.detach() + col(target_entropy))
                  ).mean(1)
        log_alpha, alpha_opt = pa(state.log_alpha, lgrad, state.alpha_opt,
                                  lr_override=h["alpha_lr"])

        new_state = SACState(
            actor=actor, critic=critic,
            target_critic=_soft_update(state.target_critic, critic, TAU),
            log_alpha=log_alpha, actor_opt=actor_opt, critic_opt=critic_opt,
            alpha_opt=alpha_opt, step=state.step + 1)
        return new_state, {"critic_loss": closs.detach(),
                           "actor_loss": aloss.detach(),
                           "alpha": torch.exp(log_alpha)}

    return update
