"""TD3 (Fujimoto et al., 2018), functional and population-batched
(``repro.rl.td3``).

Every hyperparameter the paper's PBT study tunes (§B.1) is a per-member
input (the ``hypers`` dict of ``(N,)`` vectors): actor_lr, critic_lr,
policy_freq (0.2..1), noise, discount. The delayed policy update is the
fractional-frequency gate ``floor((step+1) f) > floor(step f)``, member by
member.

The state holds no PRNG key (the JAX package's ``key`` leaf): updates draw
their target-smoothing noise from a ``torch.Generator`` given per call.

Two updates, as in the JAX package: :func:`update`, one member's step on
plain dense layers and the stock :func:`repro_torch.optim.adam` (the
``sequential`` backend loops it over the members and launches no
kernel), and :func:`make_population_update`, every member at once through
the ``pop_matmul`` and ``pop_adam`` kernels (the ``vectorized`` backend).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.distributed import member_draw
from repro_torch.device import device_tensor
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.rl import networks as nets
from repro_torch.tree import flatten, tree_map, unflatten

DEFAULT_HYPERS = {
    "actor_lr": 3e-4, "critic_lr": 3e-4, "policy_freq": 0.5,
    "noise": 0.2, "discount": 0.99,
}
NOISE_CLIP = 0.5
TAU = 0.005

_opt_init, _opt_update = adam(3e-4)


class TD3State(NamedTuple):
    actor: Any
    critic: Any
    target_actor: Any
    target_critic: Any
    actor_opt: Any
    critic_opt: Any
    step: torch.Tensor


def actor_init(generator, obs_dim: int, act_dim: int, hidden=nets.HIDDEN, *,
               device="cpu"):
    """One member's actor parameters (all that serving needs)."""
    return nets.actor_init(generator, obs_dim, act_dim, hidden=hidden,
                           device=device)


def init(generator, obs_dim: int, act_dim: int, hidden=nets.HIDDEN, *,
         device="cpu") -> TD3State:
    actor = actor_init(generator, obs_dim, act_dim, hidden=hidden,
                       device=device)
    critic = nets.critic_init(generator, obs_dim, act_dim, hidden=hidden,
                              device=device)
    return TD3State(
        actor=actor, critic=critic,
        target_actor=tree_map(torch.clone, actor),
        target_critic=tree_map(torch.clone, critic),
        actor_opt=_opt_init(actor), critic_opt=_opt_init(critic),
        step=torch.zeros((), dtype=torch.int32, device=device))


def policy(actor_params, obs, generator=None,
           exploration_noise: float = 0.1):
    """Deterministic tanh action; with a generator, plus clipped gaussian
    exploration noise."""
    a = nets.actor_apply(actor_params, obs)
    if generator is not None:
        noise = torch.randn(a.shape, generator=generator,
                            device=generator.device).to(a.device)
        a = torch.clamp(a + exploration_noise * noise, -1.0, 1.0)
    return a


def pop_policy(actors, obs, generator=None, exploration_noise=0.1):
    """Population-level :func:`policy`: member-stacked actors on (N,B,obs)
    observations, each linear one ``pop_matmul``. ``exploration_noise`` is
    a scalar or an ``(N,)`` per-member scale."""
    a = nets.pop_actor_apply(actors, obs)
    if generator is not None:
        scale = device_tensor(exploration_noise, a.dtype, a.device)
        if scale.ndim:
            scale = scale.reshape(-1, *(1,) * (a.ndim - 1))
        noise = member_draw(torch.randn, a.shape, generator).to(a.device)
        a = torch.clamp(a + scale * noise, -1.0, 1.0)
    return a


def critic_loss_fn(critic, target_actor, target_critic, batch, eps, hypers):
    """One member's twin-Q loss; ``eps`` is the standard normal draw (B, act)
    of the target-policy smoothing."""
    with torch.no_grad():
        noise = torch.clamp(hypers["noise"] * eps, -NOISE_CLIP, NOISE_CLIP)
        next_a = torch.clamp(
            nets.actor_apply(target_actor, batch["next_obs"]) + noise,
            -1.0, 1.0)
        tq1, tq2 = nets.critic_apply(target_critic, batch["next_obs"],
                                     next_a)
        target = batch["reward"] + hypers["discount"] * \
            (1 - batch["done"]) * torch.minimum(tq1, tq2)
    q1, q2 = nets.critic_apply(critic, batch["obs"], batch["action"])
    return ((q1 - target) ** 2).mean() + ((q2 - target) ** 2).mean()


def actor_loss_fn(actor, critic, batch):
    a = nets.actor_apply(actor, batch["obs"])
    q1, _ = nets.critic_apply(critic, batch["obs"], a)
    return -q1.mean()


def _soft_update(target, online, tau=TAU):
    return tree_map(lambda t, o: (1 - tau) * t + tau * o, target, online)


def _grad_tree(loss, tree):
    """d loss / d every leaf of ``tree`` (leaves that require grad), in the
    tree's structure."""
    flat, treedef = flatten(tree)
    return unflatten(treedef, torch.autograd.grad(loss, flat))


def _with_grad(tree):
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def update(state: TD3State, batch, hypers=None, generator=None, *,
           noise=None):
    """One member's TD3 step (critic always; actor at frequency
    ``policy_freq``): batch leaves (B, ...), hypers a dict of scalars (or
    None), ``noise`` an injected (B, act) standard normal draw (drawn from
    ``generator`` otherwise). Returns ``(state, {"critic_loss",
    "actor_loss"})``."""
    h = dict(DEFAULT_HYPERS)
    if hypers:
        h.update(hypers)
    if noise is None:
        noise = torch.randn(batch["action"].shape, generator=generator,
                            device=generator.device)

    critic_in = _with_grad(state.critic)
    closs = critic_loss_fn(critic_in, state.target_actor,
                           state.target_critic, batch, noise, h)
    cgrads = _grad_tree(closs, critic_in)
    cupd, critic_opt = _opt_update(cgrads, state.critic_opt,
                                   lr_override=h["critic_lr"])
    critic = apply_updates(state.critic, cupd)

    f = torch.as_tensor(h["policy_freq"], dtype=torch.float32)
    step_f = state.step.to(torch.float32)
    do_actor = torch.floor((step_f + 1) * f) > torch.floor(step_f * f)

    actor_in = _with_grad(state.actor)
    aloss = actor_loss_fn(actor_in, critic, batch)
    agrads = _grad_tree(aloss, actor_in)
    aupd, actor_opt_new = _opt_update(agrads, state.actor_opt,
                                      lr_override=h["actor_lr"])
    actor_new = apply_updates(state.actor, aupd)

    sel = lambda new, old: tree_map(lambda a, b: torch.where(do_actor, a, b),
                                    new, old)
    actor = sel(actor_new, state.actor)
    actor_opt = sel(actor_opt_new, state.actor_opt)
    target_actor = sel(_soft_update(state.target_actor, actor),
                       state.target_actor)
    target_critic = _soft_update(state.target_critic, critic)
    new_state = TD3State(actor=actor, critic=critic,
                         target_actor=target_actor,
                         target_critic=target_critic, actor_opt=actor_opt,
                         critic_opt=critic_opt, step=state.step + 1)
    return new_state, {"critic_loss": closs.detach(),
                       "actor_loss": aloss.detach()}


def make_population_update(*, fused_linear: bool = False, fused=None):
    """Population-level TD3 update over the member-stacked state.

    ``fused_linear`` routes every population-batched linear through the
    ``pop_matmul`` wrapper (the CUDA kernel on CUDA tensors, forward and
    under autograd); otherwise through the plain einsum version. ``fused``
    goes to ``population_adam``: None runs the ``pop_adam`` wrapper (the
    Triton kernel on CUDA tensors), False its plain version.

    Returns ``update(state, batch, hypers, generator, *, noise=None) ->
    (state, metrics)``; ``batch`` leaves are (N, B, ...), ``hypers`` a dict
    of (N,) vectors or None, ``noise`` an injected (N, B, act) standard
    normal draw for the target-policy smoothing (drawn from ``generator``
    otherwise). Metrics are the per-member losses, each (N,).

    One step makes 24 ``pop_matmul`` forward calls (target actor 3, target
    critic 6, critic 6, actor 3, critic in the actor loss 6: both Q heads,
    as the JAX package's ``pop_critic_apply``) and 2 ``pop_adam`` calls.
    """
    from repro_torch.optim.pop_adam import population_adam
    from repro_torch.rl.fused import pop_hypers, pop_select
    _, pa = population_adam(3e-4, fused=fused)
    lin = None if fused_linear else False

    def critic_loss(critic, target_actor, target_critic, batch, eps, h):
        with torch.no_grad():
            noise = torch.clamp(h["noise"][:, None, None] * eps,
                                -NOISE_CLIP, NOISE_CLIP)
            next_a = torch.clamp(
                nets.pop_actor_apply(target_actor, batch["next_obs"],
                                     fused=lin) + noise, -1.0, 1.0)
            tq1, tq2 = nets.pop_critic_apply(target_critic,
                                             batch["next_obs"], next_a,
                                             fused=lin)
            target = batch["reward"] + h["discount"][:, None] * \
                (1 - batch["done"]) * torch.minimum(tq1, tq2)
        q1, q2 = nets.pop_critic_apply(critic, batch["obs"], batch["action"],
                                       fused=lin)
        return ((q1 - target) ** 2).mean(1) + ((q2 - target) ** 2).mean(1)

    def actor_loss(actor, critic, batch):
        a = nets.pop_actor_apply(actor, batch["obs"], fused=lin)
        q1, _ = nets.pop_critic_apply(critic, batch["obs"], a, fused=lin)
        return -q1.mean(1)

    def update(state: TD3State, batch, hypers=None, generator=None, *,
               noise=None):
        n = state.step.shape[0]
        h = pop_hypers(DEFAULT_HYPERS, hypers, n, state.step.device)
        if noise is None:
            noise = member_draw(torch.randn, batch["action"].shape,
                                generator)

        # members are independent: the gradient of the summed per-member
        # losses IS the stacked per-member gradients
        critic_in = _with_grad(state.critic)
        closs = critic_loss(critic_in, state.target_actor,
                            state.target_critic, batch, noise, h)
        cgrads = _grad_tree(closs.sum(), critic_in)
        critic, critic_opt = pa(state.critic, cgrads, state.critic_opt,
                                lr_override=h["critic_lr"])

        f = h["policy_freq"]
        step_f = state.step.to(torch.float32)
        do_actor = torch.floor((step_f + 1) * f) > torch.floor(step_f * f)

        # the actor loss reads the UPDATED critic and differentiates the
        # actor only
        actor_in = _with_grad(state.actor)
        aloss = actor_loss(actor_in, critic, batch)
        agrads = _grad_tree(aloss.sum(), actor_in)
        actor_new, actor_opt_new = pa(state.actor, agrads, state.actor_opt,
                                      lr_override=h["actor_lr"])

        actor = pop_select(do_actor, actor_new, state.actor)
        actor_opt = pop_select(do_actor, actor_opt_new, state.actor_opt)
        target_actor = pop_select(do_actor,
                                  _soft_update(state.target_actor, actor),
                                  state.target_actor)
        target_critic = _soft_update(state.target_critic, critic)
        new_state = TD3State(actor=actor, critic=critic,
                             target_actor=target_actor,
                             target_critic=target_critic, actor_opt=actor_opt,
                             critic_opt=critic_opt, step=state.step + 1)
        return new_state, {"critic_loss": closs.detach(),
                           "actor_loss": aloss.detach()}

    return update

