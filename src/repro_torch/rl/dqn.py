"""DQN (Mnih et al., 2013), functional and population-batched
(``repro.rl.dqn``).

Per-member hyperparameters: lr, discount, epsilon (exploration). The
target network is synced every ``TARGET_UPDATE_EVERY`` steps of each
member's own clock, read after the step's increment. ``conv_torso=True``
gives the Atari CNN of the paper's Fig. 2 DQN study; the MLP drives
cartpole and acrobot.

Two updates, as in the JAX package: :func:`update`, one member's step on
plain layers (and the torso's ``F.conv2d``) with the stock
:func:`repro_torch.optim.adam` (the ``sequential`` backend), and
:func:`make_population_update`, every member at once through the
``pop_matmul`` and ``pop_adam`` kernels (the ``vectorized`` backend; MLP
Q-networks only). DQN draws nothing in its update: ``generator`` and
``noise`` are taken for the updates' common signature and unused.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from repro_torch.core.distributed import member_draw
from repro_torch.device import device_tensor
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.rl import networks as nets
from repro_torch.rl.td3 import _grad_tree, _with_grad
from repro_torch.tree import tree_map

DEFAULT_HYPERS = {"lr": 1e-4, "discount": 0.99, "epsilon": 0.05}
TARGET_UPDATE_EVERY = 100

_opt_init, _opt_update = adam(1e-4)


class DQNState(NamedTuple):
    q: Any
    target_q: Any
    opt: Any
    step: torch.Tensor


def actor_init(generator, obs_dim: int, num_actions: int, hidden=nets.HIDDEN,
               conv_torso: bool = False, *, device="cpu"):
    """One member's Q-network (all that serving needs)."""
    return nets.q_net_init(generator, obs_dim, num_actions, hidden=hidden,
                           conv_torso=conv_torso, device=device)


def init(generator, obs_dim: int, num_actions: int, conv_torso: bool = False,
         hidden=nets.HIDDEN, *, device="cpu") -> DQNState:
    q = actor_init(generator, obs_dim, num_actions, hidden=hidden,
                   conv_torso=conv_torso, device=device)
    return DQNState(q=q, target_q=tree_map(torch.clone, q), opt=_opt_init(q),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def epsilon_greedy(greedy, epsilon, u, random_actions):
    """``random_actions`` where the uniform draw ``u`` is under
    ``epsilon`` (a scalar, or an (N,) per-member vector over (N, ...)
    actions), else ``greedy``."""
    eps = device_tensor(epsilon, u.dtype, u.device)
    if eps.ndim:
        eps = eps.reshape(-1, *(1,) * (u.ndim - 1))
    return torch.where(u < eps, random_actions, greedy)


def _act(qvals, generator, epsilon):
    greedy = torch.argmax(qvals, dim=-1)
    if generator is None:
        return greedy
    u = member_draw(torch.rand, greedy.shape, generator).to(greedy.device)
    rand = member_draw(functools.partial(torch.randint, 0, qvals.shape[-1]),
                       greedy.shape, generator).to(greedy.device)
    return epsilon_greedy(greedy, epsilon, u, rand)


def policy(q_params, obs, generator=None, epsilon=0.05):
    """The greedy action (int64); with a generator, epsilon-greedy."""
    return _act(nets.q_net_apply(q_params, obs), generator, epsilon)


def pop_policy(qs, obs, generator=None, epsilon=0.05):
    """Population-level :func:`policy`: member-stacked Q-networks on
    (N,B,obs) observations, each linear one ``pop_matmul``; ``epsilon`` a
    scalar or an (N,) per-member vector."""
    return _act(nets.pop_q_net_apply(qs, obs), generator, epsilon)


def _td_loss(qvals, tq, batch, discount):
    """Mean squared TD error over the batch axis (the last but one)."""
    # gather takes int64 indices; the replay ring stores int32 actions
    qa = torch.gather(qvals, -1, batch["action"].long()[..., None])[..., 0]
    target = batch["reward"] + discount * (1 - batch["done"]) * \
        tq.max(-1).values
    return ((qa - target) ** 2).mean(-1)


def update(state: DQNState, batch, hypers=None, generator=None, *,
           noise=None):
    """One member's DQN step: batch leaves (B, ...), hypers a dict of
    scalars (or None). Returns ``(state, {"loss"})``."""
    h = dict(DEFAULT_HYPERS)
    if hypers:
        h.update(hypers)
    q_in = _with_grad(state.q)
    with torch.no_grad():
        tq = nets.q_net_apply(state.target_q, batch["next_obs"])
    loss = _td_loss(nets.q_net_apply(q_in, batch["obs"]), tq, batch,
                    h["discount"])
    upd, opt = _opt_update(_grad_tree(loss, q_in), state.opt,
                           lr_override=h["lr"])
    q = apply_updates(state.q, upd)
    step = state.step + 1
    sync = (step % TARGET_UPDATE_EVERY) == 0
    target_q = tree_map(lambda t, o: torch.where(sync, o, t),
                        state.target_q, q)
    return DQNState(q=q, target_q=target_q, opt=opt, step=step), \
        {"loss": loss.detach()}


def make_population_update(*, fused_linear: bool = False, fused=None):
    """Population-level DQN update over the member-stacked state
    (``fused_linear`` and ``fused`` as in
    :func:`repro_torch.rl.td3.make_population_update`). The target sync is
    a member-masked select on each member's step after the increment.

    Returns ``update(state, batch, hypers, generator, *, noise=None) ->
    (state, {"loss": (N,)})``. One step makes 6 ``pop_matmul`` forward
    calls (the Q-network 3, the target network 3) and 1 ``pop_adam``
    call."""
    from repro_torch.optim.pop_adam import population_adam
    from repro_torch.rl.fused import pop_hypers, pop_select
    _, pa = population_adam(1e-4, fused=fused)
    lin = None if fused_linear else False

    def update(state: DQNState, batch, hypers=None, generator=None, *,
               noise=None):
        n = state.step.shape[0]
        h = pop_hypers(DEFAULT_HYPERS, hypers, n, state.step.device)
        q_in = _with_grad(state.q)
        with torch.no_grad():
            tq = nets.pop_q_net_apply(state.target_q, batch["next_obs"],
                                      fused=lin)
        loss = _td_loss(nets.pop_q_net_apply(q_in, batch["obs"], fused=lin),
                        tq, batch, h["discount"][:, None])
        q, opt = pa(state.q, _grad_tree(loss.sum(), q_in), state.opt,
                    lr_override=h["lr"])
        step = state.step + 1
        sync = (step % TARGET_UPDATE_EVERY) == 0
        return DQNState(q=q, target_q=pop_select(sync, q, state.target_q),
                        opt=opt, step=step), {"loss": loss.detach()}

    return update
