"""The port's DQN against the JAX package's ``repro.rl.dqn``.

The Q-networks (the MLP, and the Atari torso carried across from JAX's
HWIO weights to the port's OIHW ones), the greedy and epsilon-greedy
policies (JAX's draws injected), and the updates across the target sync:
members start at steps 97, 98 and 50, so a chain of three steps syncs
the first two members' target networks at different steps and the third's
not at all. Tolerance rtol = 1e-4, atol = 1e-5 (the JAX package's own for
the TD3 comparison). Small widths: hidden (32, 32), N = 3, B = 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.population import member as jax_member
from repro.core.population import population_init as jax_population_init
from repro.core.vectorize import chain_steps as jax_chain_steps
from repro.envs import make as jax_make
from repro.nn.basic import dqn_torso_apply as jax_torso_apply
from repro.rl import dqn as jax_dqn
from repro.rl import make_agent as jax_make_agent
from repro.rl import networks as jax_nets
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import PolicyForward as JaxForward
from repro.serve import make_serving_set as jax_make_serving_set
from repro_torch.convert import from_jax_params, to_numpy
from repro_torch.core.population import member
from repro_torch.core.vectorize import chain_steps
from repro_torch.envs import make
from repro_torch.optim import AdamState
from repro_torch.pop import ModuleAgent, make_update
from repro_torch.rl import dqn, make_agent
from repro_torch.rl import networks as nets
from repro_torch.rollout.collector import exploration_policy
from repro_torch.serve import BatchServer, PolicyForward, make_serving_set
from repro_torch.tree import leaves, tree_map
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401
from test_torch_train import train_then_serve

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

N, B, OBS, ACTIONS, HIDDEN = 3, 8, 4, 3, (32, 32)
TOL = dict(rtol=1e-4, atol=1e-5)
HYPERS = {"lr": [1e-3, 3e-4, 5e-4], "discount": [0.99, 0.95, 0.9],
          "epsilon": [0.05, 0.2, 0.1]}
START_STEPS = [97, 98, 50]


def _jax_state(conv_torso=False, n=N):
    return jax_population_init(
        lambda k: jax_dqn.init(k, OBS, ACTIONS, conv_torso=conv_torso,
                               hidden=HIDDEN),
        jax.random.PRNGKey(5), n)


def _at_steps(js):
    """The state with the members' clocks at START_STEPS."""
    step = jnp.asarray(START_STEPS, jnp.int32)
    return js._replace(step=step, opt=js.opt._replace(step=step))


def _port_state(js):
    c = from_jax_params
    return dqn.DQNState(q=c(js.q), target_q=c(js.target_q),
                        opt=AdamState(step=c(js.opt.step), mu=c(js.opt.mu),
                                      nu=c(js.opt.nu)), step=c(js.step))


def _batches(k, seed=0, obs_shape=(OBS,), lead=(N,)):
    rng = np.random.default_rng(seed)
    shape = (k,) + lead + (B,)
    return {"obs": rng.standard_normal(shape + obs_shape).astype(np.float32),
            "action": rng.integers(0, ACTIONS, shape).astype(np.int32),
            "reward": rng.standard_normal(shape).astype(np.float32),
            "next_obs": rng.standard_normal(shape + obs_shape).astype(
                np.float32),
            "done": (rng.random(shape) < 0.2).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_state_close(port, js):
    for f in dqn.DQNState._fields:
        got, want = leaves(getattr(port, f)), jax.tree.leaves(getattr(js, f))
        assert len(got) == len(want), f
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f)


def test_mlp_q_net_greedy_and_epsilon_greedy_match_jax():
    js = _jax_state()
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((N, B, OBS)).astype(np.float32)
    qs = from_jax_params(js.q)
    q = nets.pop_q_net_apply(qs, torch.from_numpy(obs))
    jq = jax.jit(jax_nets.pop_q_net_apply)(js.q, jnp.asarray(obs))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **TOL)
    one = nets.q_net_apply(member(_port_state(js), 1).q,
                           torch.from_numpy(obs[1]))
    np.testing.assert_allclose(one.numpy(), np.asarray(jq[1]), **TOL)
    # the greedy actions, on Q-values without near ties
    top2 = np.sort(np.asarray(jq), -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3
    greedy = dqn.pop_policy(qs, torch.from_numpy(obs))
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jnp.argmax(jq, -1)))
    jpolicy = jax.jit(jax_dqn.policy)
    np.testing.assert_array_equal(
        dqn.policy(member(_port_state(js), 1).q,
                   torch.from_numpy(obs[1])).numpy(),
        np.asarray(jpolicy(jax_member(js, 1).q, jnp.asarray(obs[1]))))

    # epsilon-greedy with JAX's draws injected, member by member
    eps = np.asarray(HYPERS["epsilon"], np.float32) * 4     # some random
    for i in range(N):
        key = jax.random.PRNGKey(20 + i)
        kr, ka = jax.random.split(key)
        u = np.asarray(jax.random.uniform(kr, (B,)))
        rand = np.asarray(jax.random.randint(ka, (B,), 0, ACTIONS))
        want = jax.jit(jax_dqn.policy)(jax_member(js, i).q,
                                       jnp.asarray(obs[i]), key,
                                       epsilon=float(eps[i]))
        got = dqn.epsilon_greedy(greedy[i], float(eps[i]),
                                 torch.from_numpy(u), torch.from_numpy(rand))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a per-member epsilon vector picks each member's own rate
    u = torch.full((N, B), 0.15)
    picked = dqn.epsilon_greedy(greedy, torch.tensor([0.1, 0.2, 0.0]), u,
                                torch.full((N, B), 7))
    assert (picked[1] == 7).all() and not (picked[[0, 2]] == 7).any()


def test_exploration_policy_acts_epsilon_greedily_per_member():
    """The collector's branch for DQN: each member's ``epsilon`` hyper;
    epsilon 0 is greedy, epsilon 1 uniform over the actions."""
    qs = from_jax_params(_jax_state().q)
    obs = torch.randn((N, 512, OBS), generator=torch.Generator()
                      .manual_seed(0))
    act = exploration_policy(dqn)(qs, obs, torch.Generator().manual_seed(1),
                                  {"epsilon": torch.tensor([0.0, 1.0, 0.0])})
    greedy = dqn.pop_policy(qs, obs)
    assert act.shape == (N, 512)
    assert torch.equal(act[[0, 2]], greedy[[0, 2]])
    counts = torch.bincount(act[1], minlength=ACTIONS)
    assert counts.min() > 100                       # ~171 of 512 each


def test_torso_q_net_and_member_update_match_jax():
    """The Atari torso: JAX's HWIO conv weights carried across to OIHW,
    the (B, 3136) features and Q-values, one member's update through
    ``F.conv2d`` and the stock Adam, and the weights carried back."""
    js = jax_member(_jax_state(conv_torso=True, n=1), 0)
    assert js.q["torso"]["conv_0"]["w"].shape == (8, 8, 4, 32)
    port = _port_state(js)
    assert port.q["torso"]["conv_0"]["w"].shape == (32, 4, 8, 8)
    # the agent carries conv_torso to init and actor_init: the layout of
    # the converted state, leaf for leaf
    agent = ModuleAgent(dqn, OBS, ACTIONS, device="cpu", conv_torso=True)
    gen = torch.Generator().manual_seed(0)
    for mine, conv in ((agent.init(gen), port),
                       (agent.actor_init(gen), port.q)):
        assert [tuple(x.shape) for x in leaves(mine)] == \
            [tuple(x.shape) for x in leaves(conv)]
    for a, b in zip(jax.tree.leaves(js.q), leaves(to_numpy(port.q))):
        np.testing.assert_array_equal(np.asarray(a), b)
    batch = {k: v[0, 0] for k, v in _batches(
        1, seed=2, obs_shape=(84, 84, 4), lead=(1,)).items()}
    batch["obs"] = np.abs(batch["obs"])      # frames, non-negative
    batch["next_obs"] = np.abs(batch["next_obs"])
    feats = jax.jit(jax_torso_apply)(js.q["torso"],
                                     jnp.asarray(batch["obs"]))
    got = nets.dqn_torso_apply(port.q["torso"],
                               torch.from_numpy(batch["obs"]))
    assert got.shape == (B, 3136)
    np.testing.assert_allclose(got.numpy(), np.asarray(feats), **TOL)
    np.testing.assert_allclose(
        nets.q_net_apply(port.q, torch.from_numpy(batch["obs"])).numpy(),
        np.asarray(jax.jit(jax_nets.q_net_apply)(
            js.q, jnp.asarray(batch["obs"]))), **TOL)

    hypers = {"lr": 1e-3, "discount": 0.95}
    jnew, jm = jax.jit(jax_dqn.update)(js, _j(batch), hypers)
    new, m = dqn.update(port, _t(batch), hypers)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               **TOL)
    # the gradients, read off Adam's moments after its first step (mu =
    # 0.1 g, nu = 0.001 g^2); then the parameters, except where a gradient
    # is nonzero but within 1e-6 of 0 in either: a step of lr g / (|g| +
    # 1e-8) swings by up to lr as |g| crosses Adam's eps, and the ReLU
    # torso's all-but-dead features give the head such gradients
    flat = lambda t: leaves(to_numpy(t))
    for f in ("mu", "nu"):
        for g, w in zip(flat(getattr(new.opt, f)),
                        jax.tree.leaves(getattr(jnew.opt, f))):
            np.testing.assert_allclose(g, np.asarray(w), **TOL, err_msg=f)
    for g, w, mu, jmu in zip(flat(new.q), jax.tree.leaves(jnew.q),
                             flat(new.opt.mu), jax.tree.leaves(jnew.opt.mu)):
        small = np.minimum(np.abs(mu), np.abs(np.asarray(jmu)))
        big = np.maximum(np.abs(mu), np.abs(np.asarray(jmu)))
        held = (big == 0) | (small > 0.1 * 1e-6)
        assert held.mean() > 0.99
        np.testing.assert_allclose(g[held], np.asarray(w)[held], **TOL)


def test_member_update_matches_jax_across_the_sync():
    """Member 1 (step 98) stepped twice with the stock update: its target
    network syncs at step 100, after the second step."""
    js = jax_member(_at_steps(_jax_state()), 1)
    port = member(_port_state(_at_steps(_jax_state())), 1)
    batches = _batches(2, seed=3, lead=())
    hypers = {k: float(v[1]) for k, v in HYPERS.items()}
    jupdate = jax.jit(jax_dqn.update)
    for k in range(2):
        batch = {key: v[k] for key, v in batches.items()}
        js, jm = jupdate(js, _j(batch), hypers)
        port, m = dqn.update(port, _t(batch), hypers)
        _assert_state_close(port, js)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                                   **TOL)
        synced = all(torch.equal(a, b) for a, b in
                     zip(leaves(port.q), leaves(port.target_q)))
        assert synced == (k == 1)


@pytest.mark.parametrize("steps", [1, 3])
def test_population_update_matches_jax_across_the_sync(steps):
    """``steps`` chained population steps of the port's kernel route
    against JAX's ``make_population_update(fused_linear=True,
    fused=False)`` from members at steps 97, 98 and 50: after 3 steps
    members 0 and 1 have synced (at their steps 100), member 2 not."""
    js = _at_steps(_jax_state())
    batches = _batches(steps, seed=steps)
    hypers = {k: np.asarray(v, np.float32) for k, v in HYPERS.items()}
    jnew, jm = jax_chain_steps(
        jax_dqn.make_population_update(fused_linear=True, fused=False),
        steps)(js, _j(batches), _j(hypers))
    new, m = chain_steps(dqn.make_population_update(fused_linear=True),
                         steps)(_port_state(js), _t(batches), _t(hypers))
    _assert_state_close(new, jnew)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               **TOL)
    np.testing.assert_array_equal(new.step.numpy(),
                                  np.asarray(START_STEPS) + steps)
    # member 0 synced at its last step, member 1 a step before it (so its
    # target holds the Q-network of its step 100), member 2 never
    start = from_jax_params(js.target_q)
    same = lambda t, u, i: all(torch.equal(a[i], b[i]) for a, b in
                               zip(leaves(t), leaves(u)))
    assert [same(new.q, new.target_q, i) for i in range(N)] == \
        [steps == 3, False, False]
    assert [same(new.target_q, start, i) for i in range(N)] == \
        [steps < 3, steps < 2, True]


def test_population_update_counts_and_plain_route(monkeypatch):
    """One step makes 6 pop_matmul calls and 1 pop_adam call through the
    wrappers; the plain route makes none and gives the same state."""
    import repro_torch.kernels.pop_adam as pa_mod
    import repro_torch.kernels.pop_matmul as pm_mod
    calls = {"pop_matmul": 0, "pop_adam": 0}
    fwd, plain = pm_mod._forward, pa_mod.pop_adam_plain

    def count_mm(*a, **kw):
        calls["pop_matmul"] += 1
        return fwd(*a, **kw)

    def count_adam(*a, **kw):
        calls["pop_adam"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(pm_mod, "_forward", count_mm)
    monkeypatch.setattr(pa_mod, "pop_adam_plain", count_adam)
    state = _port_state(_at_steps(_jax_state()))
    batch = _t({k: v[0] for k, v in _batches(1).items()})
    kern, _ = dqn.make_population_update(fused_linear=True)(state, batch)
    assert calls == {"pop_matmul": 6, "pop_adam": 1}
    ref, _ = dqn.make_population_update(fused_linear=False, fused=False)(
        state, batch)
    assert calls == {"pop_matmul": 6, "pop_adam": 1}
    for a, b in zip(leaves(kern), leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_pop_q_net_apply_refuses_the_torso():
    """As the JAX package's does: the torso has no population-batched
    path (the refusal comes before any weight is read)."""
    torso = {"torso": {}, "head": {}}
    with pytest.raises(ValueError, match="no population-batched path"):
        nets.pop_q_net_apply(torso, torch.zeros((2, 1, 84, 84, 4)))
    with pytest.raises(ValueError, match="no population-batched path"):
        jax_nets.pop_q_net_apply(torso, jnp.zeros((2, 1, 84, 84, 4)))


@pytest.mark.parametrize("num_steps", [1, 2])
def test_sequential_matches_vectorized(num_steps):
    """The sequential backend and the vectorized one agree, across the
    sync of a member at step 99."""
    agent = ModuleAgent(dqn, OBS, ACTIONS, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    state = state._replace(step=torch.tensor([99, 10, 98], dtype=torch.int32))
    lead = (num_steps,) if num_steps > 1 else ()
    batch = _t({k: v[0] if not lead else v for k, v in
                _batches(num_steps, seed=5).items()})
    hypers = _t({k: np.asarray(v, np.float32) for k, v in HYPERS.items()})
    seq, ms = make_update(agent, "sequential", num_steps=num_steps)(
        tree_map(torch.clone, state), batch, hypers)
    vec, mv = make_update(agent, "vectorized", num_steps=num_steps)(
        state, batch, hypers)
    for a, b in zip(leaves(seq), leaves(vec)):
        torch.testing.assert_close(a, b, **TOL)
    torch.testing.assert_close(ms["loss"], mv["loss"], **TOL)


def test_batch_server_vote_matches_jax():
    """The population-level serve head (argmax of the Q-values, one
    pop_matmul a layer) in ``vote`` mode answers as JAX's server."""
    jagent = jax_make_agent("dqn", jax_make("cartpole").spec)
    actors = jagent.actor_params(jagent.population_init(
        jax.random.PRNGKey(1), 5))
    theirs = JaxBatchServer(
        JaxForward.fused_for_agent(jagent), jax_make("cartpole").spec,
        jax_make_serving_set(actors, np.arange(5), step=0),
        max_batch=16, mode="vote")
    agent = make_agent("dqn", make("cartpole").spec, device="cpu")
    ours = BatchServer(PolicyForward.fused_for_agent(agent),
                       make("cartpole").spec,
                       make_serving_set(from_jax_params(actors),
                                        np.arange(5), step=0),
                       max_batch=16, mode="vote")
    obs = np.random.default_rng(0).standard_normal((16, 4)).astype(
        np.float32)
    members = PolicyForward.for_agent(agent).members(
        ours.set.params, torch.from_numpy(obs))
    assert members.shape == (5, 16)
    got = ours.serve(obs)
    np.testing.assert_array_equal(got, theirs.serve(obs))
    # the plurality of the members' greedy actions
    votes = np.stack([(members.numpy() == a).sum(0) for a in range(2)], -1)
    np.testing.assert_array_equal(got, np.argmax(votes, -1))


# (env, strategy, backend, serving mode): both strategies, both backends
_CLI = (("cartpole", "pbt", "sequential", "vote"),
        ("cartpole", "cem", "vectorized", "vote"))


@pytest.mark.parametrize("env, strategy, backend, mode", _CLI,
                         ids=["-".join(c[:3]) for c in _CLI])
def test_train_cli_then_serve_cli(tmp_path, capsys, env, strategy, backend,
                                  mode):
    """DQN through the train CLI (PBT or CEM, either backend) and the
    serve CLI (`vote`) on the checkpoint it wrote, on the CPU."""
    train_then_serve(tmp_path, capsys, "dqn", env, strategy, backend,
                     mode)
