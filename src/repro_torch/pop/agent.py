"""The agent adapters (``repro.pop.agent``): what ``PopTrainer``, the
update backends, the rollout engine and the serving layer consume.

  * ``ModuleAgent`` — a functional RL module (td3, sac, dqn): per-member
    state, a per-member ``update`` and a population-level
    ``fused_update``.
  * ``PPOAgent``    — ``ModuleAgent`` over ppo, the on-policy agent:
    ``experience_kind = "trajectory"``, and the state-value head GAE
    bootstraps from.
  * ``LMAgent``     — the language-model train step: state is (params,
    opt_state, step), fitness is -loss.
  * ``SharedCriticAgent`` — the §4.2 family (CEM-RL, DvD): ONE critic
    shared by the population, so the update is population-level
    (``population_level = True``), and the backend picks between the
    paper's averaged-loss update and the original CEM-RL ordering.

``update`` is one member's step (the ``sequential`` backend loops it over
the members); ``fused_update`` is the population-level update (the
``vectorized`` backend). ``gather_members`` is PBT's exploit; the LM
agent's writes member ``parents[i]``'s state into member i's slot of the
population's own tensors, so the views of its flat buffers stay valid.
``evolvable_params`` and ``with_evolvable_params`` are what a
parameter-space strategy (CEM) reads and replaces: the policies.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.distributed import take_rows
from repro_torch.core.population import population_init
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.optim.optimizers import AdamState
from repro_torch.tree import flat_buffer, flat_empty, leaves, tree_map


class ModuleAgent:
    """Adapter for a module exposing ``init(generator, obs_dim, act_dim,
    device=..., **init_kwargs) -> state``, ``actor_init`` (one member's
    policy alone), ``policy``/``pop_policy`` and ``make_population_update``.

    The policy is the state's ``actor`` field, its ``q`` field (DQN) or
    its ``params`` field (PPO: the whole ``{actor, critic[, log_std]}``
    tree); ``init_kwargs`` (DQN's ``conv_torso``) go to
    ``init`` and ``actor_init``. ``device`` is where the agent's parameters
    live: the CUDA device unless the caller passes ``"cpu"``. The
    population-level update always goes through the ``pop_matmul`` and
    ``pop_adam`` wrappers: the kernels on CUDA tensors, their plain
    versions on CPU tensors.
    """

    population_level = False     # the update is NOT the shared-critic kind
    experience_kind = "replay"   # transitions from a FIFO ring

    def __init__(self, module, obs_dim: int, act_dim: int, *,
                 device=DEFAULT_DEVICE, **init_kwargs):
        self.module = module
        self.exploration_module = module
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.device = resolve_device(device)
        self.init_kwargs = init_kwargs

    @property
    def default_hypers(self) -> dict:
        return dict(getattr(self.module, "DEFAULT_HYPERS", {}))

    def init(self, generator):
        return self.module.init(generator, self.obs_dim, self.act_dim,
                                device=self.device, **self.init_kwargs)

    def population_init(self, generator, n: int, *, rows=None):
        """``n`` members drawn from ``generator``; with ``rows`` (a
        :class:`repro_torch.core.distributed.Rows`) only those members'
        rows are kept (every member is drawn, so each has its one-rank
        parameters)."""
        state = population_init(self.init, generator, n)
        return state if rows is None else take_rows(state, rows)

    def actor_init(self, generator, *, device="cpu"):
        """One member's actor parameters, without the rest of the state."""
        return self.module.actor_init(generator, self.obs_dim, self.act_dim,
                                      device=device, **self.init_kwargs)

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

    @staticmethod
    def _field(state) -> str:
        return next(f for f in ("actor", "q", "params") if hasattr(state, f))

    def actor_params(self, pop_state):
        return getattr(pop_state, self._field(pop_state))

    def evolvable_params(self, pop_state):
        return self.actor_params(pop_state)

    def with_evolvable_params(self, pop_state, new_params):
        """The state with new policies, copied into the target policies
        too where the state has them (TD3's ``target_actor``, DQN's
        ``target_q``; SAC and PPO have none)."""
        field = self._field(pop_state)
        repl = {field: new_params}
        if hasattr(pop_state, "target_" + field):
            repl["target_" + field] = tree_map(torch.clone, new_params)
        return pop_state._replace(**repl)

    def gather_members(self, pop_state, parents):
        """PBT exploit: member i adopts member ``parents[i]``'s state."""
        return tree_map(lambda x: x[parents], pop_state)


class PPOAgent(ModuleAgent):
    """Adapter for :mod:`repro_torch.rl.ppo`, the on-policy (trajectory)
    agent. It plugs into the same backends and strategies as the other
    module agents; what differs is declared: ``experience_kind =
    "trajectory"`` makes the rollout engine collect fixed-length rollouts
    with the policy's log_prob and value extras, run GAE on the device and
    feed shuffled epoch minibatches to the update. ``discrete`` picks the
    categorical head (a discrete env) over the gaussian one."""

    experience_kind = "trajectory"

    def __init__(self, obs_dim: int, act_dim: int, *, discrete: bool = False,
                 device=DEFAULT_DEVICE, **init_kwargs):
        from repro_torch.rl import ppo
        super().__init__(ppo, obs_dim, act_dim, device=device,
                         discrete=discrete, **init_kwargs)

    def value(self, actor_params, obs):
        """One member's state value (the head GAE bootstraps from)."""
        return self.module.value(actor_params, obs)

    def pop_value(self, actors, obs):
        """Every member's state values at once: member-stacked params on
        (N, B, obs) -> (N, B), one ``pop_matmul`` a layer."""
        from repro_torch.rl import networks as nets
        return nets.pop_value_apply(actors["critic"], obs)


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
    Every parameter evolves under CEM, as in the JAX package; the CEM
    strategy samples and redraws the parameters' buffer in place
    (``evolvable_buffer``). A restore (``PopTrainer.resume``, or
    ``repro_torch.elastic.restore_elastic`` at another population size)
    writes the checkpoint's rows into the same buffers, so the leaves
    stay their views and ``pop_adam`` steps them in place after it.

    ``model_sharded_params``: over an island's model axis the members are
    sharded by the rules of :mod:`repro_torch.models.sharding`
    (``population_init(shard=...)``, ``fused_update(shard=...)``); the
    buffers then hold this rank's parts, ``(N_island, P_local)``.
    """

    model_sharded_params = True

    def __init__(self, cfg, tcfg, *, device=DEFAULT_DEVICE):
        from repro_torch.models import lm
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self._lm = lm
        _, self._train_step = lm.make_train_step(cfg, tcfg)

    def _member_params(self, seed: int):
        member_gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._lm.init_params(member_gen, self.cfg)

    def shard_dims(self, tree, shard, *, lead: int = 1) -> list:
        """For each leaf of ``tree`` (a state, or any tree whose leaves
        end in parameter paths, with ``lead`` leading axes), the dimension
        ``shard``'s rules split, or None; all None without a shard."""
        from repro_torch.models.sharding import tree_paths
        paths = tree_paths(tree)
        if shard is None or shard.size <= 1:
            return [None] * len(paths)
        table = self._lm.shard_table(self.cfg, shard.size)
        out = []
        for path in paths:
            hit = next((d for p, d in table.items()
                        if path == p or path.endswith("." + p)), None)
            out.append(None if hit is None else hit + lead)
        return out

    def part_map(self, shard):
        """This rank's :class:`~repro_torch.models.sharding.PartMap` of one
        member's parameters over ``shard``: which columns of the whole
        member's raveled vector its parts are, and where its flat buffer
        holds them (what CEM refits and redraws a sharded member by);
        None without a shard."""
        if shard is None or shard.size <= 1:
            return None
        from repro_torch.models.sharding import PartMap
        shapes = self._lm.param_shapes(self.cfg)
        return PartMap([tuple(x.shape) for x in leaves(shapes)],
                       self.shard_dims(shapes, shard, lead=0), shard)

    def population_init(self, generator, n: int, *, rows=None, shard=None):
        """``n`` members in flat ``(N, P)`` buffers (parameters, mu, nu),
        drawn and written one member at a time. With ``rows`` (a
        :class:`repro_torch.core.distributed.Rows`) the buffers hold only
        those members: every member's seed is drawn, and those of the rows
        are built, so each has its one-rank parameters. With ``shard`` (a
        :class:`repro_torch.models.sharding.ModelShard`) they hold this
        rank's parts of each member, cut from the whole member by the
        rules."""
        from repro_torch.models.sharding import local_tree
        sharded = shard is not None and shard.size > 1
        if sharded:
            dims = self.shard_dims(self._lm.param_shapes(self.cfg), shard,
                                   lead=0)
        member_params = (self._member_params if not sharded else
                         lambda seed: local_tree(
                             self._member_params(seed), dims, shard))
        seeds = [int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                   device=generator.device))
                 for _ in range(n)]
        keep = range(n) if rows is None else range(rows.lo, rows.hi)
        first = member_params(seeds[keep[0]])
        n = len(keep)
        like = tree_map(lambda x: x[None].expand((n,) + x.shape), first)
        _, params = flat_empty(like)
        for i, m in enumerate(keep):
            member = first if i == 0 else member_params(seeds[m])
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

    def fused_update(self, shard=None):
        """The population update: one ``pop_adam`` launch a step (a rank's,
        over its parts of the members, with ``shard``)."""
        return self._lm.make_population_update(self.cfg, self.tcfg,
                                               shard=shard)

    def actor_params(self, pop_state):
        return pop_state.params

    def evolvable_params(self, pop_state):
        return pop_state.params

    def with_evolvable_params(self, pop_state, new_params):
        return pop_state._replace(params=new_params)

    def evolvable_buffer(self, pop_state):
        """The flat ``(N, P)`` buffer whose views the parameters are, which
        CEM samples and redraws in place (``pop.strategy.CEM``)."""
        return flat_buffer(pop_state.params)

    def fitness_from_metrics(self, metrics):
        return -metrics["loss"]

    def gather_members(self, pop_state, parents):
        """PBT exploit, written into the population's tensors one leaf at
        a time (never replacing them, so the leaves stay views of the flat
        buffers; the copy made on the way is one leaf's)."""
        tree_map(lambda x: x.copy_(x[parents]), pop_state)
        return pop_state


class SharedCriticAgent:
    """Adapter for the §4.2 shared-critic update
    (:mod:`repro_torch.core.shared`), the CEM-RL and DvD case studies.

    The state is a ``SharedCriticState``: member-stacked policies and ONE
    critic, so the update consumes the whole population at once
    (``population_update``; there is no per-member ``update``).
    ``dvd_coef_fn``, set here or by the ``DvD`` strategy, turns on the
    determinant diversity term. Acting and evaluation use TD3's policy.
    ``device`` is where the state lives: the CUDA device unless the
    caller passes ``"cpu"``.
    """

    population_level = True
    experience_kind = "replay"

    def __init__(self, obs_dim: int, act_dim: int, *, dvd_coef_fn=None,
                 probe_size: int = 20, train_frac: float = 1.0,
                 device=DEFAULT_DEVICE):
        from repro_torch.core import shared
        from repro_torch.rl import td3
        self._shared = shared
        self.exploration_module = td3
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.dvd_coef_fn = dvd_coef_fn
        self.probe_size = probe_size
        self.train_frac = train_frac
        self.device = resolve_device(device)

    def population_init(self, generator, n: int):
        return self._shared.init(generator, self.obs_dim, self.act_dim, n,
                                 device=self.device)

    def population_update(self, *, sequential: bool = False):
        """The whole-population update: the paper's averaged critic loss
        through the kernels, or the original CEM-RL ordering (the
        baseline arm, no kernel)."""
        if sequential:
            return self._shared.sequential_shared_critic_update()
        return self._shared.make_shared_critic_update(
            dvd_coef_fn=self.dvd_coef_fn, probe_size=self.probe_size,
            train_frac=self.train_frac)

    def update(self, state, batch, hypers=None, generator=None, *,
               noise=None):
        raise TypeError("SharedCriticAgent is population_level; backends "
                        "use population_update() instead of update()")

    def fitness_from_metrics(self, metrics):
        """None: fitness comes from the evaluator's episode returns."""
        return None

    def policy(self, actor_params, obs, generator=None):
        return self.exploration_module.policy(actor_params, obs, generator)

    def actor_params(self, pop_state):
        return pop_state.policies

    def evolvable_params(self, pop_state):
        return pop_state.policies

    def with_evolvable_params(self, pop_state, new_params):
        """The state with new policies, copied into the target policies
        too; the critic and the Adam state stay."""
        return pop_state._replace(
            policies=new_params,
            target_policies=tree_map(torch.clone, new_params))

    def gather_members(self, pop_state, parents):
        """PBT exploit over the per-member parts only: the shared critic
        and the step have no member axis."""
        take = lambda tree: tree_map(lambda x: x[parents], tree)
        return pop_state._replace(
            policies=take(pop_state.policies),
            target_policies=take(pop_state.target_policies),
            policy_opt=take(pop_state.policy_opt))
