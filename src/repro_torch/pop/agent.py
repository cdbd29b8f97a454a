"""The agent adapters (``repro.pop.agent``): what ``PopTrainer``, the
update backends, the rollout engine and the serving layer consume.

  * ``ModuleAgent`` — a functional RL module (td3): per-member state, a
    per-member ``update`` and a population-level ``fused_update``.
  * ``LMAgent``     — the language-model train step: state is (params,
    opt_state, step), fitness is -loss.

``update`` is one member's step (the ``sequential`` backend loops it over
the members); ``fused_update`` is the population-level update (the
``vectorized`` backend). ``gather_members`` is PBT's exploit; the LM
agent's writes member ``parents[i]``'s state into member i's slot of the
population's own tensors, so the views of its flat buffers stay valid.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.population import population_init
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.optim.optimizers import AdamState
from repro_torch.tree import flat_empty, tree_map




class ModuleAgent:
    """Adapter for a module exposing ``init(generator, obs_dim, act_dim,
    device=...) -> state`` (a state with an ``actor`` field),
    ``actor_init`` (one member's actor alone), ``policy``/``pop_policy``
    and ``make_population_update``.

    ``device`` is where the agent's parameters live: the CUDA device unless
    the caller passes ``"cpu"``. The population-level update always goes
    through the ``pop_matmul`` and ``pop_adam`` wrappers: the kernels on
    CUDA tensors, their plain versions on CPU tensors.
    """

    population_level = False     # the update is NOT the shared-critic kind
    experience_kind = "replay"   # transitions from a FIFO ring

    def __init__(self, module, obs_dim: int, act_dim: int, *,
                 device=DEFAULT_DEVICE):
        self.module = module
        self.exploration_module = module
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.device = resolve_device(device)

    @property
    def default_hypers(self) -> dict:
        return dict(getattr(self.module, "DEFAULT_HYPERS", {}))

    def init(self, generator):
        return self.module.init(generator, self.obs_dim, self.act_dim,
                                device=self.device)

    def population_init(self, generator, n: int):
        return population_init(self.init, generator, n)

    def actor_init(self, generator, *, device="cpu"):
        """One member's actor parameters, without the rest of the state."""
        return self.module.actor_init(generator, self.obs_dim, self.act_dim,
                                      device=device)

    def update(self, state, batch, hypers=None, generator=None, *,
               noise=None):
        """One member's step on plain dense layers and the stock Adam."""
        return self.module.update(state, batch, hypers, generator,
                                  noise=noise)

    def fused_update(self):
        """The module's population-level update, every linear through the
        ``pop_matmul`` wrapper and every Adam step through ``pop_adam``."""
        return self.module.make_population_update(fused_linear=True)

    def fitness_from_metrics(self, metrics):
        """None: an RL member's fitness comes from its episode returns."""
        return None

    def policy(self, actor_params, obs, generator=None):
        return self.module.policy(actor_params, obs, generator)

    def actor_params(self, pop_state):
        return pop_state.actor

    def gather_members(self, pop_state, parents):
        """PBT exploit: member i adopts member ``parents[i]``'s state."""
        return tree_map(lambda x: x[parents], pop_state)


class LMState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor  # per-member step drives the LR schedule


class LMAgent:
    """Adapter for ``repro_torch.models.lm``'s train steps.

    Per-member PBT hypers are ``lr_scale`` (the paper's LM study),
    ``weight_decay`` and ``warmup_frac``; fitness is the negative loss.
    ``fused_update`` is ``lm.make_population_update`` (one ``pop_adam``
    launch a step for the whole population), ``update`` one member's
    ``lm.make_train_step`` (the stock AdamW, no kernel).

    ``population_init`` keeps the population's float32 parameters and
    Adam moments each in ONE flat ``(N, P)`` buffer whose views are the
    tree's leaves (:func:`repro_torch.tree.flat_views`), so the population
    update writes them in place. Member i's parameters are drawn by
    ``lm.init_params`` on the agent's device, from a generator seeded by
    the i-th draw of the generator given (so a seed gives the same
    population on one device, and different ones on the CPU and the card).
    """

    def __init__(self, cfg, tcfg, *, device=DEFAULT_DEVICE):
        from repro_torch.models import lm
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self._lm = lm
        _, self._train_step = lm.make_train_step(cfg, tcfg)

    def _draw_params(self, generator):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        member_gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._lm.init_params(member_gen, self.cfg)

    def population_init(self, generator, n: int):
        """``n`` members in flat ``(N, P)`` buffers (parameters, mu, nu),
        drawn and written one member at a time."""
        first = self._draw_params(generator)
        like = tree_map(lambda x: x[None].expand((n,) + x.shape), first)
        _, params = flat_empty(like)
        for i in range(n):
            member = first if i == 0 else self._draw_params(generator)
            tree_map(lambda d, x: d[i].copy_(x), params, member)
            del member
        del first

        def zeros():
            buffer, views = flat_empty(params)
            buffer.zero_()
            return views

        step = lambda: torch.zeros((n,), dtype=torch.int32,
                                   device=self.device)
        return LMState(params=params,
                       opt_state=AdamState(step=step(), mu=zeros(),
                                           nu=zeros()),
                       step=step())

    def update(self, state: LMState, batch, hypers=None, generator=None, *,
               noise=None):
        """One member's step with the stock AdamW (no kernel)."""
        h = hypers if hypers else {}
        params, opt_state, metrics = self._train_step(
            state.params, state.opt_state, batch, state.step,
            lr_scale=h.get("lr_scale"), weight_decay=h.get("weight_decay"),
            warmup_frac=h.get("warmup_frac"))
        return LMState(params, opt_state, state.step + 1), metrics

    def fused_update(self):
        """The population update: one ``pop_adam`` launch a step."""
        return self._lm.make_population_update(self.cfg, self.tcfg)

    def actor_params(self, pop_state):
        return pop_state.params

    def fitness_from_metrics(self, metrics):
        return -metrics["loss"]

    def gather_members(self, pop_state, parents):
        """PBT exploit, written into the population's tensors one leaf at
        a time (never replacing them, so the leaves stay views of the flat
        buffers; the copy made on the way is one leaf's)."""
        tree_map(lambda x: x.copy_(x[parents]), pop_state)
        return pop_state
