"""The port's PPO against the JAX package's ``repro.rl.ppo``.

The networks' log-probs and entropies, the acting step with JAX's draws
injected (the standard normal draw of a continuous action, the Gumbel
draw behind ``jax.random.categorical``), one member's update on the
stock path, the population update through the ``pop_matmul`` and
``pop_adam`` wrappers (their plain versions on the CPU) against JAX's
``make_population_update(fused_linear=True)``, the two backends against
each other, the serve heads, and the train and serve CLIs with the
checkpoint they leave read back by JAX. Small widths: hidden (32, 32),
N = 3, B = 8; the CLIs run at the port's full width, on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.core.population import member as jax_member
from repro.core.population import population_init as jax_population_init
from repro.core.vectorize import chain_steps as jax_chain_steps
from repro.envs import make as jax_make
from repro.rl import make_agent as jax_make_agent
from repro.rl import networks as jax_nets
from repro.rl import ppo as jax_ppo
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import PolicyForward as JaxForward
from repro.serve import load_actor_stack as jax_load_actor_stack
from repro.serve import make_serving_set as jax_make_serving_set
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import PopulationConfig
from repro_torch.convert import from_jax_params, to_numpy
from repro_torch.core.population import member
from repro_torch.core.vectorize import chain_steps
from repro_torch.envs import make
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.optim import AdamState
from repro_torch.pop import PopTrainer, make_update
from repro_torch.rl import get_algo, make_agent, ppo
from repro_torch.rl import networks as nets
from repro_torch.rollout.collector import exploration_policy
from repro_torch.serve import (BatchServer, PolicyForward, load_actor_stack,
                               make_serving_set)
from repro_torch.tree import leaves, tree_map
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

N, B, HIDDEN = 3, 8, (32, 32)
TOL = dict(rtol=1e-5, atol=1e-6)
NET_TOL = dict(rtol=1e-6, atol=1e-6)
# (obs, act, discrete): pendulum's and cartpole's dims
SPACES = {"continuous": (3, 1, False), "discrete": (4, 2, True)}
HYPERS = {"lr": [1e-3, 3e-4, 5e-4], "clip_eps": [0.2, 0.1, 0.3],
          "entropy_coef": [0.01, 0.0, 0.03], "value_coef": [0.5, 1.0, 0.25]}
# a gradient within this of zero takes an Adam step its rounding decides
GRAD_FLOOR = 1e-7


def _jax_state(kind, n=N):
    obs, act, discrete = SPACES[kind]
    return jax_population_init(
        lambda k: jax_ppo.init(k, obs, act, discrete=discrete,
                               hidden=HIDDEN),
        jax.random.PRNGKey(5), n)


def _port_state(js):
    c = from_jax_params
    return ppo.PPOState(params=c(js.params),
                        opt=AdamState(step=c(js.opt.step), mu=c(js.opt.mu),
                                      nu=c(js.opt.nu)),
                        step=c(js.step))


def _batches(kind, js, k, seed=0):
    """``k`` steps of (N, B) minibatches: the collected log-probs are the
    policy's own plus noise, so some ratios clip and some do not."""
    obs_dim, act, discrete = SPACES[kind]
    rng = np.random.default_rng(seed)
    shape = (k, N, B)
    out = {"obs": rng.standard_normal(shape + (obs_dim,)).astype(np.float32)}
    out["action"] = (rng.integers(0, act, shape).astype(np.int32) if discrete
                     else rng.standard_normal(shape + (act,)).astype(
                         np.float32))
    logp, _ = jax.vmap(jax.vmap(jax_ppo.log_prob_entropy),
                       in_axes=(None, 0, 0))(
        js.params, jnp.asarray(out["obs"]), jnp.asarray(out["action"]))
    out["log_prob"] = (np.asarray(logp) + 0.2 * rng.standard_normal(
        shape)).astype(np.float32)
    for key in ("value", "advantage", "return"):
        out[key] = rng.standard_normal(shape).astype(np.float32)
    return out


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_metrics(got, want):
    assert set(got) == set(want) == {"policy_loss", "value_loss", "entropy",
                                     "approx_kl"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def _fresh(state):
    """The state with its Adam state zeroed (either package's): one step
    from it leaves the step's gradients in Adam's first moment (mu = 0.1
    g)."""
    if isinstance(state.step, torch.Tensor):
        return state._replace(opt=tree_map(torch.zeros_like, state.opt))
    return state._replace(opt=jax.tree.map(jnp.zeros_like, state.opt))


def _grads(state):
    """The gradients of a step from a ``_fresh`` state, as numpy."""
    return [np.asarray(m) / 0.1 for m in
            (leaves(to_numpy(state.opt.mu))
             if isinstance(state.step, torch.Tensor)
             else jax.tree.leaves(state.opt.mu))]


def _assert_steps_close(grads, jgrads, params, jparams):
    """Each step's gradients everywhere (``grads`` and ``jgrads``: one list
    of leaves per step), then the parameters after the last step where
    every step's gradient is exactly 0 in both packages or clears
    GRAD_FLOOR in both (an Adam step lr g / (|g| + 1e-8) on a gradient
    within rounding of 0 takes the sign rounding gives it). At least 99%
    of the parameters must be held."""
    for step, (ours, theirs) in enumerate(zip(grads, jgrads)):
        for g, r in zip(ours, theirs):
            np.testing.assert_allclose(g, r, **TOL, err_msg=f"step {step}")
    held = total = 0
    for i, (p, w) in enumerate(zip(leaves(to_numpy(params)),
                                   jax.tree.leaves(jparams))):
        keep = np.ones(p.shape, bool)
        for ours, theirs in zip(grads, jgrads):
            g, r = np.abs(ours[i]), np.abs(theirs[i])
            keep &= ((np.maximum(g, r) == 0)
                     | (np.minimum(g, r) > GRAD_FLOOR))
        np.testing.assert_allclose(p[keep], np.asarray(w)[keep], **TOL)
        held += int(keep.sum())
        total += keep.size
    assert held >= 0.99 * total, (held, total)


def test_network_functions_match_jax():
    """value and its population form, the gaussian and categorical
    log-probs and entropies, on the same inputs."""
    rng = np.random.default_rng(0)
    js = _jax_state("discrete")
    obs = rng.standard_normal((N, B, 4)).astype(np.float32)
    port = from_jax_params(js.params)
    np.testing.assert_allclose(
        nets.pop_value_apply(port["critic"], torch.from_numpy(obs)).numpy(),
        np.asarray(jax.jit(jax_nets.pop_value_apply)(js.params["critic"],
                                                     jnp.asarray(obs))),
        **NET_TOL)
    np.testing.assert_allclose(
        nets.value_apply(member(port, 1)["critic"],
                         torch.from_numpy(obs[1])).numpy(),
        np.asarray(jax_nets.value_apply(jax_member(js.params, 1)["critic"],
                                        jnp.asarray(obs[1]))), **NET_TOL)
    mean = rng.standard_normal((N, B, 2)).astype(np.float32)
    log_std = rng.uniform(-2, 1, (N, 1, 2)).astype(np.float32)
    act = rng.standard_normal((N, B, 2)).astype(np.float32)
    logits = 3 * rng.standard_normal((N, B, 5)).astype(np.float32)
    ints = rng.integers(0, 5, (N, B)).astype(np.int32)
    pairs = (
        (nets.gaussian_log_prob(*map(torch.from_numpy, (mean, log_std,
                                                        act))),
         jax_nets.gaussian_log_prob(mean, log_std, act)),
        (nets.gaussian_entropy(torch.from_numpy(log_std)),
         jax_nets.gaussian_entropy(log_std)),
        (nets.categorical_log_prob(torch.from_numpy(logits),
                                   torch.from_numpy(ints)),
         jax_nets.categorical_log_prob(logits, ints)),
        (nets.categorical_entropy(torch.from_numpy(logits)),
         jax_nets.categorical_entropy(logits)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)


@pytest.mark.parametrize("kind", list(SPACES))
def test_init_has_jax_layout(kind):
    """``init``'s state has the JAX package's tree leaf for leaf (shape
    and dtype), with ``log_std`` an explicit float32 (act,) leaf at
    LOG_STD_INIT; ``actor_init`` is its policy tree alone."""
    obs, act, discrete = SPACES[kind]
    js = jax_ppo.init(jax.random.PRNGKey(0), obs, act, discrete=discrete,
                      hidden=HIDDEN)
    gen = torch.Generator().manual_seed(0)
    state = ppo.init(gen, obs, act, discrete=discrete, hidden=HIDDEN)
    shape = lambda t: [(tuple(x.shape), str(x.dtype).split(".")[-1])
                       for x in t]
    assert shape(leaves(state)) == shape(jax.tree.leaves(js))
    assert sorted(state.params) == sorted(js.params)
    assert ("log_std" in state.params) == (not discrete)
    if not discrete:
        assert torch.equal(state.params["log_std"],
                           torch.full((act,), ppo.LOG_STD_INIT))
    pol = ppo.actor_init(gen, obs, act, hidden=HIDDEN, discrete=discrete)
    assert shape(leaves(pol)) == shape(leaves(state.params))


@pytest.mark.parametrize("kind", list(SPACES))
def test_policy_and_explore_match_jax(kind):
    """The deterministic policy, and ``explore`` member by member and
    ``pop_explore`` for the population with each member's JAX draw
    injected: the same actions, log-probs and values. The collector takes
    ``pop_explore`` as the module's exploration policy."""
    obs_dim, act, discrete = SPACES[kind]
    js = _jax_state(kind)
    port = from_jax_params(js.params)
    obs = np.random.default_rng(1).standard_normal(
        (N, B, obs_dim)).astype(np.float32)
    np.testing.assert_allclose(
        ppo.pop_policy(port, torch.from_numpy(obs)).numpy(),
        np.asarray(jax.vmap(jax_ppo.policy)(js.params, jnp.asarray(obs))),
        **NET_TOL)
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    draws, want = [], []
    for i in range(N):
        params = jax_member(js.params, i)
        a, ex = jax.jit(jax_ppo.explore)(params, jnp.asarray(obs[i]),
                                         keys[i])
        want.append((a, ex))
        if discrete:
            logits = jax_nets.mlp_apply(params["actor"], jnp.asarray(obs[i]))
            draw = jax.random.gumbel(keys[i], logits.shape)
            assert np.array_equal(np.asarray(jnp.argmax(logits + draw, -1)),
                                  np.asarray(a))
        else:
            draw = jax.random.normal(keys[i], (B, act))
        draws.append(np.array(draw))
        got, gex = ppo.explore(member(port, i), torch.from_numpy(obs[i]),
                               noise=torch.from_numpy(draws[-1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(a), **NET_TOL)
        for k in ("log_prob", "value"):
            np.testing.assert_allclose(gex[k].numpy(), np.asarray(ex[k]),
                                       **TOL)
    pa, pex = ppo.pop_explore(port, torch.from_numpy(obs),
                              noise=torch.from_numpy(np.stack(draws)))
    for i, (a, ex) in enumerate(want):
        np.testing.assert_allclose(pa[i].numpy(), np.asarray(a), **NET_TOL)
        for k in ("log_prob", "value"):
            np.testing.assert_allclose(pex[k][i].numpy(), np.asarray(ex[k]),
                                       **TOL)
    drawn, extras = exploration_policy(ppo)(
        port, torch.from_numpy(obs), torch.Generator().manual_seed(0))
    assert set(extras) == {"log_prob", "value"}
    assert drawn.shape == ((N, B) if discrete else (N, B, act))
    logp, _ = ppo._pop_log_prob_entropy(port, torch.from_numpy(obs), drawn)
    torch.testing.assert_close(extras["log_prob"], logp)


@pytest.mark.parametrize("kind", list(SPACES))
def test_member_update_matches_jax(kind):
    """Member 1 stepped twice with the stock update (plain layers, the
    stock Adam): the loss metrics of each step, the step-1 gradients and
    the parameters after step 2 (held where the gradients clear
    GRAD_FLOOR, see ``_assert_steps_close``)."""
    js_pop = _jax_state(kind)
    batches = _batches(kind, js_pop, 2, seed=3)
    js = jax_member(js_pop, 1)
    port = member(_port_state(js_pop), 1)
    hypers = {k: float(v[1]) for k, v in HYPERS.items()}
    jupdate = jax.jit(jax_ppo.update)
    grads, jgrads = [], []
    for k in range(2):
        batch = {key: v[k, 1] for key, v in batches.items()}
        grads.append(_grads(ppo.update(_fresh(port), _t(batch),
                                       hypers)[0]))
        jgrads.append(_grads(jupdate(_fresh(js), _j(batch), hypers)[0]))
        js, jm = jupdate(js, _j(batch), hypers)
        port, m = ppo.update(port, _t(batch), hypers)
        _assert_metrics(m, jm)
    _assert_steps_close(grads, jgrads, port.params, js.params)
    assert int(port.step) == 2 and int(port.opt.step) == 2


@pytest.mark.parametrize("kind", list(SPACES))
def test_population_update_matches_jax(kind):
    """Two chained population steps through the ``pop_matmul`` and
    ``pop_adam`` wrappers (their plain versions on the CPU) against JAX's
    ``make_population_update(fused_linear=True)``, members with distinct
    hypers: the chained metrics, the step-1 gradients and the parameters
    after step 2."""
    js = _jax_state(kind)
    batches = _batches(kind, js, 2, seed=4)
    hypers = {k: np.asarray(v, np.float32) for k, v in HYPERS.items()}
    jupdate = jax_ppo.make_population_update(fused_linear=True)
    update = ppo.make_population_update(fused_linear=True)
    jstep = jax.jit(jupdate)
    at = lambda k: {key: v[k] for key, v in batches.items()}
    j1, _ = jstep(js, _j(at(0)), _j(hypers))
    s1, _ = update(_port_state(js), _t(at(0)), _t(hypers))
    grads = [_grads(s1), _grads(update(_fresh(s1), _t(at(1)),
                                       _t(hypers))[0])]
    jgrads = [_grads(j1), _grads(jstep(_fresh(j1), _j(at(1)),
                                       _j(hypers))[0])]
    j2, jm = jax.jit(jax_chain_steps(jupdate, 2))(js, _j(batches),
                                                  _j(hypers))
    s2, m = chain_steps(update, 2)(_port_state(js), _t(batches), _t(hypers))
    _assert_metrics(m, jm)
    assert m["policy_loss"].shape == (N,)
    _assert_steps_close(grads, jgrads, s2.params, j2.params)
    assert s2.step.tolist() == [2] * N == s2.opt.step.tolist()


def test_population_update_counts_and_plain_route(monkeypatch):
    """One step makes 6 pop_matmul calls (the actor's 3 and the critic's
    3) and 1 pop_adam call through the wrappers, over the whole
    {actor, critic, log_std} tree; the plain route makes none and gives
    the same state."""
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
    js = _jax_state("continuous")
    state = _port_state(js)
    batch = _t({k: v[0] for k, v in _batches("continuous", js, 1).items()})
    kern, _ = ppo.make_population_update(fused_linear=True)(state, batch)
    assert calls == {"pop_matmul": 6, "pop_adam": 1}
    assert not torch.equal(kern.params["log_std"], state.params["log_std"])
    ref, _ = ppo.make_population_update(fused_linear=False, fused=False)(
        state, batch)
    assert calls == {"pop_matmul": 6, "pop_adam": 1}
    for a, b in zip(leaves(kern), leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind, num_steps", [("continuous", 1),
                                             ("discrete", 2)])
def test_vectorized_matches_sequential(kind, num_steps):
    """The sequential backend (the stock update looped over the members)
    and the vectorized one agree on the same batches and hypers, as the
    JAX package's test_ppo_vectorized_matches_sequential_backend holds."""
    obs, act, discrete = SPACES[kind]
    agent = make_agent("ppo", make("pendulum" if not discrete
                                   else "cartpole").spec, device="cpu")
    agent.init_kwargs["hidden"] = HIDDEN
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    lead = (num_steps,) if num_steps > 1 else ()
    batches = _batches(kind, _jax_state(kind), num_steps, seed=5)
    batch = _t({k: v if lead else v[0] for k, v in batches.items()})
    hypers = _t({k: np.asarray(v, np.float32) for k, v in HYPERS.items()})
    seq, ms = make_update(agent, "sequential", num_steps=num_steps)(
        tree_map(torch.clone, state), batch, hypers)
    vec, mv = make_update(agent, "vectorized", num_steps=num_steps)(
        state, batch, hypers)
    for a, b in zip(leaves(seq), leaves(vec)):
        torch.testing.assert_close(a, b, **TOL)
    for k in mv:
        torch.testing.assert_close(ms[k], mv[k], **TOL)


def _jax_actors(env_name, n=5):
    jagent = jax_make_agent("ppo", jax_make(env_name).spec)
    return jagent, jagent.actor_params(jagent.population_init(
        jax.random.PRNGKey(1), n))


@pytest.mark.parametrize("env_name, mode", [("pendulum", "mean"),
                                            ("cartpole", "vote")])
def test_batch_server_matches_jax(env_name, mode):
    """The population-level serve head (ppo's tanh mean, or the argmax of
    its logits; one pop_matmul a layer) answers as JAX's server."""
    jagent, actors = _jax_actors(env_name)
    spec = make(env_name).spec
    theirs = JaxBatchServer(
        JaxForward.fused_for_agent(jagent), jax_make(env_name).spec,
        jax_make_serving_set(actors, np.arange(5), step=0),
        max_batch=16, mode=mode)
    agent = make_agent("ppo", spec, device="cpu")
    ours = BatchServer(PolicyForward.fused_for_agent(agent), spec,
                       make_serving_set(from_jax_params(actors),
                                        np.arange(5), step=0),
                       max_batch=16, mode=mode)
    obs = np.random.default_rng(0).standard_normal(
        (16, spec.obs_dim)).astype(np.float32)
    got, want = ours.serve(obs), theirs.serve(obs)
    if mode == "vote":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the fused members equal the member-by-member forward
    fused = PolicyForward.fused_for_agent(agent).members(
        ours.set.params, torch.from_numpy(obs))
    loop = PolicyForward.for_agent(agent).members(ours.set.params,
                                                  torch.from_numpy(obs))
    torch.testing.assert_close(fused, loop, rtol=1e-5, atol=1e-6)


# (env, strategy, backend, serving mode): both action spaces, both
# backends, PBT and CEM over the whole policy tree
_CLI = (("pendulum", "pbt", "vectorized", "mean"),
        ("cartpole", "pbt", "sequential", "vote"),
        ("pendulum", "cem", "vectorized", "best"))


@pytest.mark.parametrize("env, strategy, backend, mode", _CLI,
                         ids=["-".join(c[:3]) for c in _CLI])
def test_train_cli_then_serve_cli(tmp_path, capsys, env, strategy, backend,
                                  mode):
    """PPO through the train CLI (``--epochs 2``: rollouts of 8 x 2
    transitions in minibatches of 8, 4 chained updates an iteration) and
    the serve CLI on the checkpoint it wrote, on the CPU."""
    ckpt = tmp_path / "ck"
    report = train_main([
        "--algo", "ppo", "--env", env, "--population", "3", "--steps", "4",
        "--pbt-interval", "2", "--eval-every", "1", "--num-envs", "2",
        "--collect-steps", "8", "--batch", "8", "--epochs", "2",
        "--strategy", strategy, "--backend", backend, "--fused-adam",
        "--fused-linear", "--ckpt-dir", str(ckpt), "--device", "cpu"])
    out = capsys.readouterr().out
    assert (f"[train] algo=ppo env={env} pop=3 strategy={strategy} "
            f"backend={backend} experience=trajectory") in out
    assert [it for it, _ in report.evolutions] == [2, 4]
    if strategy == "cem":
        assert all(lin == [-1, -1, -1] for _, lin in report.evolutions)
    assert np.isfinite(report.best_fitness)
    assert set(report.metrics) == {"policy_loss", "value_loss", "entropy",
                                   "approx_kl"}
    assert all(torch.isfinite(v).all() for v in report.metrics.values())
    # 4 iterations of 2 epochs x 2 minibatches
    assert report.trainer.state.opt.step.tolist() == [16] * 3
    assert CheckpointManager(ckpt).latest() == 3
    served = serve_main(["--algo", "ppo", "--env", env, "--ckpt-dir",
                         str(ckpt), "--ensemble", "3", "--mode", mode,
                         "--fused-linear", "--batch", "16", "--requests",
                         "3", "--device", "cpu"])
    assert served.server.set.size == 3
    for _, actions in served.batches:
        if env == "cartpole":
            assert actions.shape == (16,)
            assert set(np.unique(actions)) <= {0, 1}
        else:
            assert actions.shape == (16, 1)
            assert np.isfinite(actions).all() and np.abs(actions).max() <= 1


def test_ppo_checkpoint_is_read_bitwise_by_jax(tmp_path):
    """A PPO population's ``actors`` aux tree (the whole {actor, critic,
    log_std} policy tree) crosses to the JAX package's layout bit for
    bit, as TD3's does, and back into the port's serving loader."""
    agent = make_agent("ppo", make("pendulum").spec, device="cpu")
    pcfg = PopulationConfig(size=3, pbt_interval=3,
                            hyper_space=get_algo("ppo").hyper_space)
    trainer = PopTrainer(agent, pcfg, seed=1, checkpoint_dir=tmp_path)
    trainer.attach_rollout(make("pendulum"), num_envs=2, collect_steps=8,
                           batch_size=16, epochs=1, eval_envs=2)
    trainer.run_env_loop(2, eval_every=1)
    trainer.save(blocking=True)
    jagent = jax_make_agent("ppo", jax_make("pendulum").spec)
    jactors, _ = jax_load_actor_stack(JaxCheckpointManager(tmp_path), jagent)
    want = leaves(trainer.actors)
    got = jax.tree.leaves(jactors)
    assert len(got) == len(want) == 13
    assert sorted(jactors) == ["actor", "critic", "log_std"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    actors, _ = load_actor_stack(CheckpointManager(tmp_path), agent)
    for g, w in zip(leaves(actors), want):
        assert torch.equal(g, w)


def test_cli_refuses_without_cuda(tmp_path):
    """Without ``--device cpu`` both entry points need the card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--algo", "ppo", "--env", "cartpole", "--epochs", "1",
                    "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--algo", "ppo", "--env", "cartpole", "--ckpt-dir",
                    str(tmp_path)])


def test_pbt_ppo_example_runs(tmp_path):
    """``repro_torch.examples.pbt_ppo.run`` on the CPU: PBT over lr,
    clip_eps, entropy_coef and gae_lambda, with a checkpoint at its 10th
    iteration."""
    from repro_torch.examples import pbt_ppo
    out = pbt_ppo.run(population=3, iters=10, num_envs=2, collect_steps=4,
                      batch_size=8, epochs=1, pbt_every=5,
                      env_name="cartpole", ckpt_dir=tmp_path, device="cpu")
    assert np.isfinite(out["best_fitness"])
    trainer = out["trainer"]
    assert sorted(trainer.hypers) == sorted(pbt_ppo.SPACE.names)
    assert trainer.state.opt.step.tolist() == [10] * 3
    assert CheckpointManager(tmp_path).latest() == 9
