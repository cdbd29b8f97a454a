"""Shared-critic population update, the paper's §4.2 contribution
(``repro.core.shared``).

CEM-RL and DvD share ONE critic across the population while each member
owns its policy. The original CEM-RL interleaves per-member critic
updates one after another, which defeats vectorization. The paper's
change: every batch flows through all policies at once and the critic
loss is averaged over the population (the same number of critic updates,
no cost in sample efficiency: the paper's Figs. 6 and 8).

The update is TD3's (the algorithm of all three case studies):

  * critic step: the per-member TD3 critic losses, summed over the
    members that train and divided by their count, into the one critic;
  * policy step: the MEAN over members of each member's TD3 actor loss
    against the updated critic, optionally plus ``coef * dvd_loss`` of
    the members' behaviour on a probe batch.

:func:`make_shared_critic_update` is the JAX package's
``fused_linear=True, fused_adam=True`` form: the policies' forwards are
``pop_matmul`` calls (the CUDA kernel on CUDA tensors; the backward is
``PopMatmul``'s bmm) and their Adam step is one ``pop_adam`` call. The
shared critic has no member axis: it runs on plain dense layers and the
stock Adam, as in the JAX package. :func:`sequential_shared_critic_update`
is the original CEM-RL ordering, the baseline of the paper's Fig. 4, on
plain layers and the stock Adam with no kernel.

The state holds no PRNG key (the JAX package's ``key`` leaf): updates draw
the target-smoothing noise from a ``torch.Generator`` given per call, or
take it injected as ``noise``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.dvd import dvd_loss, pop_behavior_embedding
from repro_torch.core.population import member
from repro_torch.optim.optimizers import apply_updates
from repro_torch.optim.pop_adam import population_adam
from repro_torch.rl import networks as nets
from repro_torch.rl import td3
from repro_torch.rl.fused import pop_select
from repro_torch.tree import stack, tree_map


class SharedCriticState(NamedTuple):
    policies: Any          # member-stacked (N, ...) actor params
    critic: Any            # the one shared critic
    target_policies: Any
    target_critic: Any
    policy_opt: Any        # AdamState, step (N,), moments stacked
    critic_opt: Any        # AdamState, step ()
    step: torch.Tensor


def init(generator, obs_dim: int, act_dim: int, n: int, *,
         hidden=nets.HIDDEN, device="cpu") -> SharedCriticState:
    """``n`` policies drawn in turn from ``generator``, then the critic."""
    policies = stack([nets.actor_init(generator, obs_dim, act_dim,
                                      hidden=hidden, device=device)
                      for _ in range(n)])
    critic = nets.critic_init(generator, obs_dim, act_dim, hidden=hidden,
                              device=device)
    pop_init, _ = population_adam(3e-4)
    return SharedCriticState(
        policies=policies, critic=critic,
        target_policies=tree_map(torch.clone, policies),
        target_critic=tree_map(torch.clone, critic),
        policy_opt=pop_init(policies), critic_opt=td3._opt_init(critic),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _hypers(hypers):
    h = dict(td3.DEFAULT_HYPERS)
    if hypers:
        h.update(hypers)
    return h


def _draw(noise, batches, generator):
    """The (N, B, act) standard normal draw of the target smoothing."""
    if noise is None:
        noise = torch.randn(batches["action"].shape, generator=generator,
                            device=generator.device)
    return noise.to(batches["action"].device)


def make_shared_critic_update(*, dvd_coef_fn=None, probe_size: int = 20,
                              train_frac: float = 1.0, fused=None):
    """Returns ``update(state, batches, hypers, generator, *, noise=None)
    -> (state, {"critic_loss", "actor_loss"})``.

    ``batches`` leaves are (N, B, ...), one batch a member (§4.2: "each
    batch of training data goes through all of the policy networks");
    ``hypers`` a dict of scalars or None; ``noise`` the (N, B, act)
    standard normal draw of the target smoothing (drawn from ``generator``
    otherwise). ``train_frac < 1`` trains only the first ``k_train =
    max(1, round(N train_frac))`` members (CEM-RL trains half its sampled
    policies, Algorithm 1): the critic loss is the trainees' sum over
    ``k_train``, and the other members keep their policies, Adam state and
    target policies bit for bit. ``dvd_coef_fn(step)`` turns on the DvD
    term on the probe ``batches["obs"][0, :probe_size]``.

    ``fused=None`` runs the ``pop_matmul`` and ``pop_adam`` wrappers (the
    kernels on CUDA tensors); ``fused=False`` their plain versions. One
    step makes 6 ``pop_matmul`` calls (the target policies 3, the
    policies in the actor loss 3), 3 more for the DvD embedding, and 1
    ``pop_adam`` call."""
    _, pop_apply = population_adam(3e-4, fused=fused)

    def update(state: SharedCriticState, batches, hypers=None,
               generator=None, *, noise=None):
        h = _hypers(hypers)
        n = batches["obs"].shape[0]
        k_train = max(1, round(n * train_frac))
        trained = torch.arange(n, device=state.step.device) < k_train
        eps = _draw(noise, batches, generator)

        # critic step: the trainees' losses summed over k_train (§4.2)
        critic_in = td3._with_grad(state.critic)
        with torch.no_grad():
            smooth = torch.clamp(h["noise"] * eps, -td3.NOISE_CLIP,
                                 td3.NOISE_CLIP)
            next_a = torch.clamp(
                nets.pop_actor_apply(state.target_policies,
                                     batches["next_obs"], fused=fused)
                + smooth, -1.0, 1.0)
            tq1, tq2 = nets.critic_apply(state.target_critic,
                                         batches["next_obs"], next_a)
            target = batches["reward"] + h["discount"] * \
                (1 - batches["done"]) * torch.minimum(tq1, tq2)
        q1, q2 = nets.critic_apply(critic_in, batches["obs"],
                                   batches["action"])
        losses = ((q1 - target) ** 2).mean(1) + ((q2 - target) ** 2).mean(1)
        closs = torch.where(trained, losses, 0.0).sum() / k_train
        cgrads = td3._grad_tree(closs, critic_in)
        cupd, critic_opt = td3._opt_update(cgrads, state.critic_opt,
                                           lr_override=h["critic_lr"])
        critic = apply_updates(state.critic, cupd)

        # policy step: the MEAN of the members' actor losses against the
        # updated critic, plus the joint DvD term
        policies_in = td3._with_grad(state.policies)
        a = nets.pop_actor_apply(policies_in, batches["obs"], fused=fused)
        q1, _ = nets.critic_apply(critic, batches["obs"], a)
        aloss = (-q1.mean(1)).mean()
        if dvd_coef_fn is not None:
            emb = pop_behavior_embedding(
                policies_in, batches["obs"][0, :probe_size], fused=fused)
            aloss = aloss + dvd_coef_fn(state.step) * dvd_loss(emb)
        agrads = td3._grad_tree(aloss, policies_in)
        # the copying form: the in-place one would step the members that
        # do not train
        policies_new, policy_opt_new = pop_apply(
            state.policies, agrads, state.policy_opt,
            lr_override=h["actor_lr"])

        policies = pop_select(trained, policies_new, state.policies)
        policy_opt = pop_select(trained, policy_opt_new, state.policy_opt)
        new_state = SharedCriticState(
            policies=policies, critic=critic,
            target_policies=pop_select(
                trained, td3._soft_update(state.target_policies, policies),
                state.target_policies),
            target_critic=td3._soft_update(state.target_critic, critic),
            policy_opt=policy_opt, critic_opt=critic_opt,
            step=state.step + 1)
        return new_state, {"critic_loss": closs.detach(),
                           "actor_loss": aloss.detach()}

    return update


def sequential_shared_critic_update():
    """The original CEM-RL ordering (Algorithm 1), the baseline arm of the
    paper's Fig. 4: one critic step per member in turn, each on that
    member's batch and target policy, then each member's actor step
    against the final critic; every member trains. Same signature as
    :func:`make_shared_critic_update`'s update; ``noise[i]`` is member
    i's draw."""

    def update(state: SharedCriticState, batches, hypers=None,
               generator=None, *, noise=None):
        h = _hypers(hypers)
        n = batches["obs"].shape[0]
        eps = _draw(noise, batches, generator)
        critic, critic_opt = state.critic, state.critic_opt
        closs = torch.zeros((), device=state.step.device)
        for i in range(n):
            critic_in = td3._with_grad(critic)
            loss = td3.critic_loss_fn(
                critic_in, member(state.target_policies, i),
                state.target_critic, member(batches, i), eps[i], h)
            grads = td3._grad_tree(loss, critic_in)
            upd, critic_opt = td3._opt_update(grads, critic_opt,
                                              lr_override=h["critic_lr"])
            critic = apply_updates(critic, upd)
            closs = closs + loss.detach() / n

        policies, opts, alosses = [], [], []
        for i in range(n):
            policy_in = td3._with_grad(member(state.policies, i))
            loss = td3.actor_loss_fn(policy_in, critic, member(batches, i))
            grads = td3._grad_tree(loss, policy_in)
            upd, opt = td3._opt_update(grads, member(state.policy_opt, i),
                                       lr_override=h["actor_lr"])
            policies.append(apply_updates(member(state.policies, i), upd))
            opts.append(opt)
            alosses.append(loss.detach())
        policies = stack(policies)
        new_state = SharedCriticState(
            policies=policies, critic=critic,
            target_policies=td3._soft_update(state.target_policies,
                                             policies),
            target_critic=td3._soft_update(state.target_critic, critic),
            policy_opt=stack(opts), critic_opt=critic_opt,
            step=state.step + 1)
        return new_state, {"critic_loss": closs,
                           "actor_loss": torch.stack(alosses).mean()}

    return update
