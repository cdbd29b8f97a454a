"""The port's shared-critic population update (the paper's §4.2) against
the JAX package's, and the CEM-RL / DvD training path on the CPU.

The same state (JAX-initialised at the repo's width, carried across
through numpy) and batches go through JAX's ``make_shared_critic_update(
fused_adam=True, fused_linear=True)`` and the port's
``make_shared_critic_update`` for 3 chained steps, and through JAX's and
the port's ``sequential_shared_critic_update``. The target-smoothing
draws each JAX form makes are drawn in the test and injected as
``noise``: the vectorized form's member i from ``split(kc, N)[i]``, the
sequential one's from ``fold_in(kc, i)``. Tolerance rtol = 1e-4, atol =
1e-5, as ``test_torch_td3_update.py`` (fp32 sums in another order,
carried through Adam); members that do not train are held bit for bit
to their start. N = 4, B = 32.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dvd as jax_dvd
from repro.core import shared as jax_shared
from repro_torch.configs.base import PopulationConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import dvd, shared
from repro_torch.core.vectorize import chain_steps
from repro_torch.envs import make
from repro_torch.examples import cemrl as cemrl_example
from repro_torch.examples import dvd as dvd_example
from repro_torch.kernels.pop_matmul import PopMatmul, pop_matmul_plain
from repro_torch.launch.train import main as train_main
from repro_torch.optim import AdamState
from repro_torch.pop import PopTrainer, SharedCriticAgent, make_update
from repro_torch.rl import networks as nets
from repro_torch.rl import td3
from repro_torch.tree import leaves, tree_map
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

N, B, OBS, ACT, STEPS = 4, 32, 3, 2, 3
TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("policies", "critic", "target_policies", "target_critic",
          "policy_opt", "critic_opt", "step")


def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    shape = (k, N, B)
    return {"obs": rng.standard_normal(shape + (OBS,)).astype(np.float32),
            "action": rng.uniform(-1, 1, shape + (ACT,)).astype(np.float32),
            "reward": rng.standard_normal(shape).astype(np.float32),
            "next_obs": rng.standard_normal(shape + (OBS,)).astype(
                np.float32),
            "done": (rng.random(shape) < 0.2).astype(np.float32)}


def _port_state(js):
    c = from_jax_params
    opt = lambda o: AdamState(step=c(o.step), mu=c(o.mu), nu=c(o.nu))
    return shared.SharedCriticState(
        policies=c(js.policies), critic=c(js.critic),
        target_policies=c(js.target_policies),
        target_critic=c(js.target_critic), policy_opt=opt(js.policy_opt),
        critic_opt=opt(js.critic_opt), step=c(js.step))


def _assert_state_close(port, js):
    for f in FIELDS:
        got, want = leaves(getattr(port, f)), jax.tree.leaves(getattr(js, f))
        assert len(got) == len(want), f
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f)


def _vectorized_noise(key):
    """The (N, B, act) draw of one vectorized JAX step, and the next key."""
    key, kc = jax.random.split(key)
    eps = jax.vmap(lambda k: jax.random.normal(k, (B, ACT)))(
        jax.random.split(kc, N))
    return np.array(eps), key


def _sequential_noise(key):
    key, kc = jax.random.split(key)
    eps = [jax.random.normal(jax.random.fold_in(kc, i), (B, ACT))
           for i in range(N)]
    return np.stack([np.array(e) for e in eps]), key


CASES = {
    "all_train": dict(train_frac=1.0, coef=None),
    "half_train": dict(train_frac=0.5, coef=None),
    "dvd_constant": dict(train_frac=1.0, coef=0.5),
    # the schedule's lo half for steps 0 and 1, hi at step 2
    "dvd_schedule_half_train": dict(train_frac=0.5, coef="schedule"),
}


def _coef_fns(coef):
    if coef is None:
        return None, None
    if coef == "schedule":
        return (lambda s: jax_dvd.dvd_coef_schedule(s, period=4),
                lambda s: dvd.dvd_coef_schedule(s, period=4))
    return (lambda s: coef), (lambda s: coef)


@pytest.mark.parametrize("case", list(CASES))
def test_vectorized_update_matches_jax(case):
    train_frac, coef = CASES[case]["train_frac"], CASES[case]["coef"]
    jcoef, coef_fn = _coef_fns(coef)
    js = jax_shared.init(jax.random.PRNGKey(3), OBS, ACT, N)
    start = _port_state(js)
    jupd = jax.jit(jax_shared.make_shared_critic_update(
        dvd_coef_fn=jcoef, probe_size=20, train_frac=train_frac,
        fused_adam=True, fused_linear=True))
    upd = shared.make_shared_critic_update(
        dvd_coef_fn=coef_fn, probe_size=20, train_frac=train_frac)
    batches = _batches(STEPS, seed=1)
    state, key = start, js.key
    for k in range(STEPS):
        noise, key = _vectorized_noise(key)
        batch = {name: v[k] for name, v in batches.items()}
        js, jm = jupd(js, {name: jnp.asarray(v) for name, v in batch.items()},
                      None)
        state, m = upd(state, {name: torch.from_numpy(v)
                               for name, v in batch.items()},
                       noise=torch.from_numpy(noise))
        for name in ("critic_loss", "actor_loss"):
            assert m[name].shape == ()
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       **TOL)
    _assert_state_close(state, js)
    assert int(state.step) == STEPS and int(state.critic_opt.step) == STEPS

    k_train = max(1, round(N * train_frac))
    # no delayed policy update: every trainee stepped every time
    assert state.policy_opt.step.tolist() == \
        [STEPS] * k_train + [0] * (N - k_train)
    # the members that do not train keep policies, Adam state and target
    # policies bit for bit
    for f in ("policies", "policy_opt", "target_policies"):
        for got, was in zip(leaves(getattr(state, f)),
                            leaves(getattr(start, f))):
            assert torch.equal(got[k_train:], was[k_train:]), f
            assert not torch.equal(got[:k_train], was[:k_train]), f


def test_actor_loss_is_the_mean_and_critic_loss_over_the_trainees():
    """Adam's first moment after one step is 0.1 g: the policies' is the
    gradient of the MEAN of the members' losses (a sum would be N times
    it), the critic's that of the trainees' sum over k_train."""
    js = jax_shared.init(jax.random.PRNGKey(4), OBS, ACT, N)
    state = _port_state(js)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batches(1).items()}
    noise = torch.zeros((N, B, ACT))
    new, m = shared.make_shared_critic_update(train_frac=0.5)(
        state, batch, noise=noise)

    policies = tree_map(lambda p: p.detach().requires_grad_(True),
                        state.policies)
    a = nets.pop_actor_apply(policies, batch["obs"])
    q1, _ = nets.critic_apply(new.critic, batch["obs"], a)
    member_losses = -q1.mean(1)
    grads = torch.autograd.grad(member_losses.mean(), leaves(policies))
    for mu, g in zip(leaves(new.policy_opt.mu), grads):
        torch.testing.assert_close(mu[:2], 0.1 * g[:2], rtol=1e-5,
                                   atol=1e-9)
    torch.testing.assert_close(m["actor_loss"], member_losses.mean().detach())

    per_member = [td3.critic_loss_fn(
        state.critic, tree_map(lambda x: x[i], state.target_policies),
        state.target_critic, {k: v[i] for k, v in batch.items()}, noise[i],
        td3.DEFAULT_HYPERS) for i in range(N)]
    torch.testing.assert_close(m["critic_loss"],
                               (per_member[0] + per_member[1]).detach() / 2)


def test_sequential_update_matches_jax():
    js = jax_shared.init(jax.random.PRNGKey(5), OBS, ACT, N)
    state, key = _port_state(js), js.key
    jupd = jax.jit(jax_shared.sequential_shared_critic_update())
    upd = shared.sequential_shared_critic_update()
    batches = _batches(2, seed=2)
    for k in range(2):
        noise, key = _sequential_noise(key)
        batch = {name: v[k] for name, v in batches.items()}
        js, jm = jupd(js, {name: jnp.asarray(v) for name, v in batch.items()},
                      None)
        state, m = upd(state, {name: torch.from_numpy(v)
                               for name, v in batch.items()},
                       noise=torch.from_numpy(noise))
        for name in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       **TOL)
    _assert_state_close(state, js)
    # N critic steps an update, one after another
    assert int(state.critic_opt.step) == 2 * N
    assert state.policy_opt.step.tolist() == [2] * N


def test_state_layout_matches_jax():
    """``shared.init`` has JAX's leaves (shape, dtype, order) in every field
    but the absent ``key``."""
    js = jax_shared.init(jax.random.PRNGKey(0), OBS, ACT, N)
    port = shared.init(torch.Generator().manual_seed(0), OBS, ACT, N)
    assert shared.SharedCriticState._fields == \
        jax_shared.SharedCriticState._fields[:-1]
    for f in FIELDS:
        got, want = leaves(getattr(port, f)), jax.tree.leaves(getattr(js, f))
        assert [(tuple(g.shape), str(g.dtype).split(".")[-1]) for g in got] \
            == [(w.shape, str(w.dtype)) for w in want], f


@pytest.mark.parametrize("coef, calls", [(None, 6), (0.5, 9)])
def test_update_counts_kernel_calls_and_plain_route_agrees(monkeypatch, coef,
                                                           calls):
    """One step makes 6 pop_matmul calls (9 with the DvD embedding) and 1
    pop_adam call through the wrappers (the kernels' launches on the
    card); the plain route makes none and gives the same state."""
    import repro_torch.kernels.pop_adam as pa_mod
    import repro_torch.kernels.pop_matmul as pm_mod
    count = {"pop_matmul": 0, "pop_adam": 0}
    fwd, plain = pm_mod._forward, pa_mod.pop_adam_plain

    def count_mm(*a, **kw):
        count["pop_matmul"] += 1
        return fwd(*a, **kw)

    def count_adam(*a, **kw):
        count["pop_adam"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(pm_mod, "_forward", count_mm)
    monkeypatch.setattr(pa_mod, "pop_adam_plain", count_adam)
    state = shared.init(torch.Generator().manual_seed(0), OBS, ACT, N)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batches(1).items()}
    noise = torch.randn((N, B, ACT), generator=torch.Generator()
                        .manual_seed(1))
    coef_fn = None if coef is None else (lambda s: coef)
    kern, _ = shared.make_shared_critic_update(
        dvd_coef_fn=coef_fn, train_frac=0.5)(state, batch, noise=noise)
    assert count == {"pop_matmul": calls, "pop_adam": 1}
    ref, _ = shared.make_shared_critic_update(
        dvd_coef_fn=coef_fn, train_frac=0.5, fused=False)(
        state, batch, noise=noise)
    assert count == {"pop_matmul": calls, "pop_adam": 1}
    for a, b in zip(leaves(kern), leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_pop_matmul_backward_of_a_broadcast_x():
    """The DvD probe is one (P, obs) block broadcast over members (stride
    0): PopMatmul's dw for it equals that of the copied x."""
    gen = torch.Generator().manual_seed(2)
    x0 = torch.randn((20, OBS), generator=gen)
    w = torch.randn((N, OBS, 16), generator=gen).requires_grad_(True)
    b = torch.randn((N, 16), generator=gen).requires_grad_(True)
    dy = torch.randn((N, 20, 16), generator=gen)
    x = x0.unsqueeze(0).expand(N, 20, OBS)
    assert x.stride(0) == 0
    y = PopMatmul.apply(x, w, b, "relu")
    dw, db = torch.autograd.grad(y, (w, b), dy)
    w2 = w.detach().clone().requires_grad_(True)
    b2 = b.detach().clone().requires_grad_(True)
    y2 = pop_matmul_plain(x.contiguous(), w2, b2, activation="relu")
    dw2, db2 = torch.autograd.grad(y2, (w2, b2), dy)
    torch.testing.assert_close(y, y2)
    torch.testing.assert_close(dw, dw2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(db, db2, rtol=1e-5, atol=1e-6)


def test_update_draws_noise_from_the_generator():
    state = shared.init(torch.Generator().manual_seed(0), OBS, ACT, N)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batches(1).items()}
    for update in (shared.make_shared_critic_update(),
                   shared.sequential_shared_critic_update()):
        a, _ = update(state, batch, None, torch.Generator().manual_seed(1))
        b, _ = update(state, batch, None, torch.Generator().manual_seed(1))
        c, _ = update(state, batch, None, torch.Generator().manual_seed(2))
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y)
        assert not all(torch.equal(x, y) for x, y in
                       zip(leaves(a.critic), leaves(c.critic)))


def test_backend_chains_the_population_update():
    agent = SharedCriticAgent(OBS, ACT, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    batches = {k: torch.from_numpy(v) for k, v in _batches(2).items()}
    noise = torch.randn((2, N, B, ACT),
                        generator=torch.Generator().manual_seed(1))
    for backend, sequential in (("vectorized", False), ("sequential", True)):
        got, m = make_update(agent, backend, num_steps=2)(
            state, batches, None, noise=noise)
        want, _ = chain_steps(agent.population_update(sequential=sequential),
                              2)(state, batches, None, noise=noise)
        assert int(got.step) == 2 and m["critic_loss"].shape == ()
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)
    with pytest.raises(TypeError, match="population_level"):
        agent.update(state, batches)


def test_gather_members_leaves_the_critic():
    agent = SharedCriticAgent(OBS, ACT, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    parents = torch.tensor([3, 1, 3, 0])
    new = agent.gather_members(state, parents)
    for f in ("policies", "target_policies", "policy_opt"):
        for got, was in zip(leaves(getattr(new, f)),
                            leaves(getattr(state, f))):
            assert torch.equal(got, was[parents]), f
    for f in ("critic", "target_critic", "critic_opt", "step"):
        assert getattr(new, f) is getattr(state, f), f


def _env_trainer(strategy, backend, n=3):
    agent = SharedCriticAgent(OBS, 1, train_frac=0.5, device="cpu")
    pcfg = PopulationConfig(size=n, strategy=strategy, backend=backend,
                            num_steps=2, pbt_interval=1, fitness_window=1,
                            exploit_frac=0.34, dvd_period=4)
    trainer = PopTrainer(agent, pcfg, seed=1)
    trainer.attach_rollout(make("pendulum"), num_envs=2, collect_steps=8,
                           batch_size=16, buffer_capacity=256, eval_envs=2)
    return trainer


@pytest.mark.parametrize("backend", ["vectorized", "sequential"])
@pytest.mark.parametrize("strategy", ["cem", "dvd", "pbt"])
def test_pop_trainer_trains_the_shared_critic(strategy, backend):
    trainer = _env_trainer(strategy, backend)
    start = trainer.state
    if strategy == "dvd":
        assert trainer.agent.dvd_coef_fn is not None
    seen = []
    trainer.run_env_loop(
        2, eval_every=1,
        on_iter=lambda it, m, s, f, lin: seen.append((m, f, lin)))
    assert int(trainer.state.step) == 4
    for metrics, fitness, lineage in seen:
        assert fitness.shape == (3,) and torch.isfinite(fitness).all()
        assert all(torch.isfinite(v).all() for v in metrics.values())
        assert lineage.shape == (3,)
        if strategy == "cem":
            assert lineage.tolist() == [-1, -1, -1]
        elif strategy == "dvd":
            assert lineage.tolist() == [0, 1, 2]
        else:
            assert (lineage != torch.arange(3)).sum() == 1
    # one critic a population, stepped once an update (the sequential
    # arm: once a member and update)
    steps = 4 if backend == "vectorized" else 4 * 3
    assert int(trainer.state.critic_opt.step) == steps
    if strategy == "cem":
        assert float(trainer.strategy.cem_state.noise) == \
            pytest.approx(0.01 * 0.999 ** 2, rel=1e-6)
        assert not torch.equal(trainer.state.policies["layer_0"]["w"],
                               start.policies["layer_0"]["w"])


def test_examples_run_at_toy_size_on_the_cpu(capsys, tmp_path):
    """Both examples at toy size; their ``--log-dir``, refused until
    telemetry was ported, now writes a log that ``tools/report.py
    --check`` accepts, with the example's own rows (``cem``,
    ``diversity``)."""
    # 64 acting steps of 2 envs fill the examples' batch of 128 at once
    out = cemrl_example.run(population=3, iters=2, rl_steps=2,
                            collect_steps=64, device="cpu")
    assert len(out["iters"]) == 2 and np.isfinite(out["mean_fitness"])
    for row in out["iters"]:
        assert row["lineage"] == [-1, -1, -1]
        assert np.isfinite(row["critic_loss"]) and row["sigma"] > 0
    assert out["iters"][1]["cem_noise"] == pytest.approx(
        out["iters"][0]["cem_noise"] * 0.999, rel=1e-6)
    out = dvd_example.run(population=3, iters=2, collect_steps=64,
                          updates_per_iter=2, device="cpu")
    assert [r["update_steps"] for r in out["iters"]] == [2, 4]
    assert all(np.isfinite(r["logdet"]) for r in out["iters"])
    said = capsys.readouterr().out
    assert "[cemrl] iter 2" in said and "[dvd] iter 2" in said
    cemrl_example.run(population=3, iters=1, rl_steps=2, collect_steps=64,
                      device="cpu", log_dir=tmp_path / "cemrl")
    dvd_example.run(population=3, iters=1, collect_steps=64,
                    updates_per_iter=2, device="cpu",
                    log_dir=tmp_path / "dvd")
    report = Path(__file__).resolve().parent.parent / "tools" / "report.py"
    for name, kind in (("cemrl", "cem"), ("dvd", "diversity")):
        log = tmp_path / name
        subprocess.run([sys.executable, str(report), str(log), "--check"],
                       check=True, capture_output=True)
        kinds = {json.loads(line)["kind"]
                 for line in (log / "telemetry.jsonl").open()}
        assert {"run", "engine", "iter", "members", kind,
                "run_end"} <= kinds


def test_train_cli_evolves_td3_actors_with_cem(tmp_path, capsys):
    report = train_main([
        "--algo", "td3", "--env", "pendulum", "--population", "3",
        "--strategy", "cem", "--steps", "2", "--pbt-interval", "1",
        "--eval-every", "1", "--num-envs", "2", "--collect-steps", "8",
        "--updates-per-iter", "2", "--batch", "16", "--ckpt-dir",
        str(tmp_path), "--device", "cpu"])
    assert [lin for _, lin in report.evolutions] == [[-1, -1, -1]] * 2
    assert type(report.trainer.strategy).__name__ == "CEM"
    assert "strategy=CEM" in capsys.readouterr().out


def test_train_cli_refuses_cem_over_a_language_model(tmp_path):
    """CEM over a language model's parameters, once refused, runs: every
    member redrawn (lineage all -1); a strategy the CLI does not take is
    still refused."""
    args = ["--arch", "rwkv6-test", "--smoke", "--population", "2",
            "--steps", "2", "--pbt-interval", "1", "--batch", "1",
            "--seq-len", "8", "--device", "cpu"]
    report = train_main(args + ["--strategy", "cem", "--ckpt-dir",
                                str(tmp_path / "cem")])
    assert report.evolutions == [(1, [-1, -1]), (2, [-1, -1])]
    with pytest.raises(SystemExit):
        train_main(args + ["--strategy", "dvd", "--ckpt-dir",
                           str(tmp_path / "dvd")])


@pytest.mark.parametrize("rel", [
    "src/repro_torch/launch/train.py",
    "src/repro_torch/examples/cemrl.py",
    "src/repro_torch/examples/dvd.py",
])
def test_consumers_have_no_population_size_branches(rel):
    """``tests/test_pop_api.py``'s rule for the JAX package's consumers:
    population size 1 is the null strategy, never a branch."""
    src = (ROOT / rel).read_text()
    assert not re.search(
        r"if\s+(n|population|pop|args\.population)\s*[=><!]=\s*1\b", src)
    assert not re.search(r"sys\.path\.insert", src)
