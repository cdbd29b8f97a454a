"""PPO (Schulman et al., 2017), functional and population-batched
(``repro.rl.ppo``).

The on-policy member of the algorithm family: the clipped surrogate
objective with value clipping and an entropy bonus, over minibatches of a
fixed-length GAE-processed rollout (``repro_torch.data.experience``).
Per-member hyperparameters: lr, clip_eps, entropy_coef, value_coef, and
discount and gae_lambda, which the rollout engine reads for GAE.

Acting: ``explore`` returns ``(action, {"log_prob", "value"})``, the
extras the collector records beside the transition, since the update
takes the ratio against the log-prob of the distribution that sampled
the action. A continuous action is an unsquashed diagonal gaussian
around a tanh mean with a learnable state-independent ``log_std`` (the
env clips it, so the stored log-prob stays exact); a discrete action is a
categorical draw over the logits (the Gumbel-max draw of
``jax.random.categorical``). The draws come from a ``torch.Generator`` or
are injected (``noise``): the standard normal draw of the action's shape,
or the Gumbel draw of the logits' shape.

Two updates, as in the JAX package: :func:`update`, one member's step on
plain dense layers and the stock :func:`repro_torch.optim.adam` (the
``sequential`` backend), and :func:`make_population_update`, every member
at once through the ``pop_matmul`` and ``pop_adam`` kernels (the
``vectorized`` backend). PPO draws nothing in its update: ``generator``
and ``noise`` are taken for the updates' common signature and unused.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.distributed import member_draw
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.rl import networks as nets
from repro_torch.rl.td3 import _grad_tree, _with_grad

DEFAULT_HYPERS = {
    "lr": 3e-4, "clip_eps": 0.2, "entropy_coef": 0.01, "value_coef": 0.5,
    "discount": 0.99, "gae_lambda": 0.95,
}
LOG_STD_INIT = -0.5

_opt_init, _opt_update = adam(3e-4)


class PPOState(NamedTuple):
    params: Any            # {"actor", "critic"} (+ "log_std" if continuous)
    opt: Any
    step: torch.Tensor


def actor_init(generator, obs_dim: int, act_dim: int, hidden=nets.HIDDEN,
               discrete: bool = False, *, device="cpu"):
    """One member's policy tree, ``{"actor", "critic"[, "log_std"]}``: the
    whole of what the ``actors`` checkpoint tree holds and serving reads."""
    actor = (nets.logits_init(generator, obs_dim, act_dim, hidden=hidden,
                              device=device) if discrete
             else nets.actor_init(generator, obs_dim, act_dim, hidden=hidden,
                                  device=device))
    params = {"actor": actor,
              "critic": nets.value_init(generator, obs_dim, hidden=hidden,
                                        device=device)}
    if not discrete:
        params["log_std"] = torch.full((act_dim,), LOG_STD_INIT,
                                       dtype=torch.float32, device=device)
    return params


def init(generator, obs_dim: int, act_dim: int, discrete: bool = False,
         hidden=nets.HIDDEN, *, device="cpu") -> PPOState:
    params = actor_init(generator, obs_dim, act_dim, hidden=hidden,
                        discrete=discrete, device=device)
    return PPOState(params=params, opt=_opt_init(params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def _draw(generator, shape, like, discrete):
    """The acting draw: standard normal, or Gumbel(0, 1) for a categorical
    draw by argmax."""
    if discrete:
        tiny = torch.finfo(torch.float32).tiny
        u = member_draw(torch.rand, shape, generator).clamp_(min=tiny)
        return (-torch.log(-torch.log(u))).to(like.device)
    return member_draw(torch.randn, shape, generator).to(like.device)


def _act(out, log_std, generator, noise):
    """The action of a forward's output: deterministic without a
    generator or draw (the tanh mean, or the argmax of the logits), else
    sampled with the draw given or drawn."""
    discrete = log_std is None
    if generator is None and noise is None:
        return torch.argmax(out, dim=-1) if discrete else out
    if noise is None:
        noise = _draw(generator, out.shape, out, discrete)
    if discrete:
        return torch.argmax(out + noise, dim=-1)
    return out + torch.exp(log_std) * noise


def _log_prob_entropy(out, log_std, actions):
    if log_std is None:
        return (nets.categorical_log_prob(out, actions),
                nets.categorical_entropy(out))
    return (nets.gaussian_log_prob(out, log_std, actions),
            nets.gaussian_entropy(log_std).expand(out.shape[:-1]))


def _dist(params, obs):
    """(tanh mean, log_std) for continuous params, (logits, None) for
    discrete ones."""
    if "log_std" in params:
        return nets.actor_apply(params["actor"], obs), params["log_std"]
    return nets.mlp_apply(params["actor"], obs), None


def _pop_dist(params, obs, fused=None):
    """Population-level :func:`_dist`: (N,B,obs) -> (N,B,A) and the
    (N,1,A) log_std."""
    if "log_std" in params:
        return (nets.pop_actor_apply(params["actor"], obs, fused=fused),
                params["log_std"][:, None, :])
    return nets.pop_mlp_apply(params["actor"], obs, fused=fused), None


def policy(params, obs, generator=None):
    """The deterministic action without a generator (the tanh mean, or the
    argmax of the logits); with one, a sample of the acting distribution."""
    return _act(*_dist(params, obs), generator, None)


def pop_policy(params, obs, generator=None):
    """Population-level :func:`policy`: member-stacked params on (N,B,obs)
    observations, each linear one ``pop_matmul``."""
    return _act(*_pop_dist(params, obs), generator, None)


def value(params, obs):
    return nets.value_apply(params["critic"], obs)


def explore(params, obs, generator=None, hypers=None, *, noise=None):
    """The acting step: ``(action, {"log_prob", "value"})``, the log-prob
    of the sampled action taken from the same forward."""
    out, log_std = _dist(params, obs)
    action = _act(out, log_std, generator, noise)
    logp, _ = _log_prob_entropy(out, log_std, action)
    return action, {"log_prob": logp, "value": value(params, obs)}


def pop_explore(params, obs, generator=None, hypers=None, *, noise=None):
    """Population-level :func:`explore` on (N,E,obs): 6 ``pop_matmul``
    launches a step (the actor's 3, whose output also gives the log-prob,
    and the critic's 3)."""
    out, log_std = _pop_dist(params, obs)
    action = _act(out, log_std, generator, noise)
    logp, _ = _log_prob_entropy(out, log_std, action)
    return action, {"log_prob": logp,
                    "value": nets.pop_value_apply(params["critic"], obs)}


def log_prob_entropy(params, obs, actions):
    return _log_prob_entropy(*_dist(params, obs), actions)


def _pop_log_prob_entropy(params, obs, actions, fused=None):
    """Population-level ``log_prob_entropy``: member-stacked params, ``obs``
    (N,B,obs), ``actions`` (N,B[,act]) -> (N,B) each."""
    return _log_prob_entropy(*_pop_dist(params, obs, fused), actions)


def _normalised(adv):
    """Advantages normalised over the minibatch axis (the last) with the
    population std (``jnp.std``'s, ``correction=0``)."""
    mean = adv.mean(-1, keepdim=True)
    std = adv.std(-1, keepdim=True, correction=0)
    return (adv - mean) / (std + 1e-8)


def _loss_terms(logp, entropy, v, batch, adv, clip_eps):
    """The clipped-surrogate terms, each a mean over the minibatch axis
    (the last): policy loss, value loss, entropy, approximate KL."""
    ratio = torch.exp(logp - batch["log_prob"])
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    pg = -torch.minimum(ratio * adv, clipped * adv).mean(-1)
    v_clip = batch["value"] + torch.clamp(v - batch["value"], -clip_eps,
                                          clip_eps)
    vl = 0.5 * torch.maximum((v - batch["return"]) ** 2,
                             (v_clip - batch["return"]) ** 2).mean(-1)
    kl = (batch["log_prob"] - logp).mean(-1)
    return pg, vl, entropy.mean(-1), kl


def update(state: PPOState, batch, hypers=None, generator=None, *,
           noise=None):
    """One member's clipped-surrogate step on a minibatch of GAE-processed
    rollout data: ``batch`` holds obs, action, log_prob and value (as
    collected), advantage and return, leaves (B, ...); hypers a dict of
    scalars (or None). Advantages are normalised over the minibatch; the
    value loss is clipped around the collected value with the ratio's
    ``clip_eps``. Returns ``(state, {"policy_loss", "value_loss",
    "entropy", "approx_kl"})``."""
    h = dict(DEFAULT_HYPERS)
    if hypers:
        h.update(hypers)
    adv = _normalised(batch["advantage"])
    params_in = _with_grad(state.params)
    logp, entropy = log_prob_entropy(params_in, batch["obs"],
                                     batch["action"])
    pg, vl, ent, kl = _loss_terms(logp, entropy,
                                  value(params_in, batch["obs"]), batch, adv,
                                  h["clip_eps"])
    loss = pg + h["value_coef"] * vl - h["entropy_coef"] * ent
    upd, opt = _opt_update(_grad_tree(loss, params_in), state.opt,
                           lr_override=h["lr"])
    params = apply_updates(state.params, upd)
    return PPOState(params=params, opt=opt, step=state.step + 1), {
        "policy_loss": pg.detach(), "value_loss": vl.detach(),
        "entropy": ent.detach(), "approx_kl": kl.detach()}


def make_population_update(*, fused_linear: bool = False, fused=None):
    """Population-level PPO update over the member-stacked state
    (``fused_linear`` and ``fused`` as in
    :func:`repro_torch.rl.td3.make_population_update`): per-member
    clipped-surrogate gradients, and the single Adam application over the
    whole ``{actor, critic[, log_std]}`` tree with each member's ``lr``.

    Returns ``update(state, batch, hypers, generator, *, noise=None) ->
    (state, metrics)``; ``batch`` leaves are (N, B, ...), ``hypers`` a dict
    of (N,) vectors or None; advantages are normalised per member over the
    minibatch. Metrics are per member, each (N,). One step makes 6
    ``pop_matmul`` forward calls (the actor's 3 and the critic's 3), all
    differentiated, and 1 ``pop_adam`` call."""
    from repro_torch.optim.pop_adam import population_adam
    from repro_torch.rl.fused import pop_hypers
    _, pa = population_adam(3e-4, fused=fused)
    lin = None if fused_linear else False
    col = lambda v: v[:, None]

    def update(state: PPOState, batch, hypers=None, generator=None, *,
               noise=None):
        n = state.step.shape[0]
        h = pop_hypers(DEFAULT_HYPERS, hypers, n, state.step.device)
        adv = _normalised(batch["advantage"])                  # (N, B)
        # members are independent: the gradient of the summed per-member
        # losses IS the stacked per-member gradients
        params_in = _with_grad(state.params)
        logp, entropy = _pop_log_prob_entropy(params_in, batch["obs"],
                                              batch["action"], lin)
        v = nets.pop_value_apply(params_in["critic"], batch["obs"],
                                 fused=lin)
        pg, vl, ent, kl = _loss_terms(logp, entropy, v, batch, adv,
                                      col(h["clip_eps"]))
        per = pg + h["value_coef"] * vl - h["entropy_coef"] * ent
        params, opt = pa(state.params, _grad_tree(per.sum(), params_in),
                         state.opt, lr_override=h["lr"])
        return PPOState(params=params, opt=opt, step=state.step + 1), {
            "policy_loss": pg.detach(), "value_loss": vl.detach(),
            "entropy": ent.detach(), "approx_kl": kl.detach()}

    return update
