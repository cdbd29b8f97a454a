"""The port's overlapped engine (``repro_torch.rollout.OverlapEngine``),
chunked collection and the train CLI's acting-engine flags, as
``tests/test_overlap.py`` holds the JAX package's.

  * ``policy_lag=0`` equals the serial engine bit for bit (state, the
    generator's state, buffers, env states) for td3, sac, dqn and ppo;
  * ``policy_lag=1`` acts one update behind: update(t) consumes the slot
    collect(t-1) produced, and collect(t+1) acts with the actors of the
    state update(t) started from;
  * ``chunk_steps`` collects in chunks with the same results as a whole
    collect, in the serial engine and at either lag;
  * the flags reach the engine through ``launch/train.py`` on hopper2d.

On the CPU the lag-1 collect runs after the update; on the card it runs
on a second stream (``chip_smoke.py`` measures the overlap).
"""
import pytest
import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.envs import make
from repro_torch.launch.train import main as train_main
from repro_torch.pop import PopTrainer
from repro_torch.rl import get_algo, make_agent
from repro_torch.rollout.engine import RolloutEngine
from repro_torch.rollout.overlap import OverlapEngine
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

ALGO_ENV = {"td3": "pendulum", "sac": "pendulum",
            "dqn": "cartpole", "ppo": "cartpole"}


def _build(algo, *, policy_lag=None, chunk_steps=None, pbt_interval=100):
    env = make(ALGO_ENV[algo])
    pcfg = PopulationConfig(
        size=3, strategy="pbt", backend="vectorized",
        num_steps=1 if algo == "ppo" else 2, pbt_interval=pbt_interval,
        fitness_window=10, hyper_space=get_algo(algo).hyper_space)
    tr = PopTrainer(make_agent(algo, env.spec, hidden=(8, 8), device="cpu"),
                    pcfg, seed=7)
    kwargs = dict(num_envs=2, collect_steps=8, eval_envs=2, eval_steps=20,
                  policy_lag=policy_lag, chunk_steps=chunk_steps)
    if algo == "ppo":
        tr.attach_rollout(env, batch_size=16, epochs=1, **kwargs)
    else:
        tr.attach_rollout(env, batch_size=16, buffer_capacity=512, **kwargs)
    return tr


def _assert_trees_equal(a, b, msg):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        assert torch.equal(x, y), msg


def _assert_engines_equal(ta, tb, msg):
    _assert_trees_equal(ta.state, tb.state, f"{msg}: population state")
    assert torch.equal(ta.generator.get_state(), tb.generator.get_state())
    _assert_trees_equal(ta.rollout.bufs, tb.rollout.bufs, f"{msg}: buffers")
    _assert_trees_equal(ta.rollout.vstate, tb.rollout.vstate,
                        f"{msg}: env states")


def _run(tr, iters=5, eval_every=2):
    tr.run_env_loop(iters, eval_every=eval_every)
    return tr


@pytest.mark.parametrize("algo", sorted(ALGO_ENV))
def test_lag0_bitwise_matches_serial(algo):
    serial = _run(_build(algo))
    assert type(serial.rollout) is RolloutEngine
    lag0 = _run(_build(algo, policy_lag=0))
    assert isinstance(lag0.rollout, OverlapEngine)
    _assert_engines_equal(serial, lag0, f"{algo} lag0 vs serial")


@pytest.mark.parametrize("algo", ["td3", "ppo"])
def test_chunked_collect_bitwise_matches_unchunked(algo):
    whole = _run(_build(algo))
    chunked = _run(_build(algo, chunk_steps=4))
    _assert_engines_equal(whole, chunked, f"{algo} chunked vs whole")
    assert chunked.rollout.chunk_steps == 4


@pytest.mark.parametrize("lag", [0, 1])
def test_lag_with_chunk_steps_matches_unchunked(lag):
    """The overlapped engine takes ``chunk_steps`` at either lag, with the
    unchunked engine's results."""
    whole = _run(_build("td3", policy_lag=lag))
    chunked = _run(_build("td3", policy_lag=lag, chunk_steps=2))
    _assert_engines_equal(whole, chunked, f"lag {lag} chunked vs whole")
    if lag:
        _assert_trees_equal(whole.rollout._pending[0],
                            chunked.rollout._pending[0],
                            "the slot in flight")


def test_chunk_steps_must_divide_collect_steps():
    with pytest.raises(ValueError, match="chunk_steps"):
        _build("td3", chunk_steps=3)   # collect_steps=8
    with pytest.raises(ValueError, match="chunk_steps"):
        _build("ppo", chunk_steps=3)


@pytest.mark.parametrize("algo", ["td3", "ppo"])
def test_lag1_off_by_one_property(algo):
    """collect(t+1) acts with actors(state_t), taken before update(t), and
    update(t) consumes exactly the slot collect(t-1) produced (the
    prologue's for t = 0)."""
    tr = _build(algo, policy_lag=1)
    eng = tr.rollout
    calls = []
    collect, update_on = eng.collect, eng.update_on

    def spy_collect(actors, *args):
        out = collect(actors, *args)
        calls.append(("collect", actors, out[1]))
        return out

    def spy_update(state, bufs, slot, *args):
        calls.append(("update", state, slot))
        return update_on(state, bufs, slot, *args)

    eng.collect, eng.update_on = spy_collect, spy_update
    pre_states = []
    for _ in range(4):
        pre_states.append(tr.state)
        tr.env_iteration()
    assert [c[0] for c in calls] == ["collect"] + ["update", "collect"] * 4
    collects = [c for c in calls if c[0] == "collect"]
    updates = [c for c in calls if c[0] == "update"]
    for t, (_, state, slot) in enumerate(updates):
        assert leaves(slot)[0] is leaves(collects[t][2])[0], \
            f"update {t} took the wrong slot"
        _assert_trees_equal(state, pre_states[t], f"update {t} state")
    for t, (_, actors, _) in enumerate(collects[1:]):
        _assert_trees_equal(actors, eng.agent.actor_params(pre_states[t]),
                            f"collect {t + 1} not one update behind")


def test_lag1_runs_and_trains():
    tr = _build("td3", policy_lag=1, pbt_interval=3)
    seen = []
    tr.run_env_loop(6, eval_every=1,
                    on_iter=lambda it, m, s, f, lin: seen.append(lin))
    assert tr.rollout._pending is not None
    assert sum(lin is not None for lin in seen) == 2
    assert all(torch.isfinite(x).all() for x in leaves(tr.state)
               if x.is_floating_point())
    assert tr.rollout.iterations == 6


def test_lag1_validates_lag_values():
    with pytest.raises(ValueError, match="policy_lag"):
        _build("td3", policy_lag=2)


def test_lag1_fused_epoch_unsupported():
    tr = _build("td3", policy_lag=1)
    with pytest.raises(NotImplementedError):
        tr.rollout.build_epoch(epoch_len=4)
    with pytest.raises(NotImplementedError):
        tr.run_env_loop(4, eval_every=0, fused=True)
    lag0 = _build("td3", policy_lag=0)
    lag0.run_env_loop(4, eval_every=2, fused=True)
    assert lag0.step_count == 4


CLI = ["--env", "hopper2d", "--population", "3", "--steps", "4",
       "--pbt-interval", "2", "--eval-every", "1", "--num-envs", "2",
       "--collect-steps", "4", "--device", "cpu"]


@pytest.mark.parametrize("algo,flags", [
    ("td3", ["--fused-epoch", "--updates-per-iter", "2", "--batch", "8"]),
    ("ppo", ["--chunk-steps", "2", "--batch", "4", "--epochs", "2"]),
    ("td3", ["--policy-lag", "1", "--updates-per-iter", "2", "--batch", "8"]),
], ids=["td3-fused-epoch", "ppo-chunk-steps", "td3-policy-lag"])
def test_train_cli_runs_the_acting_engine_flags(tmp_path, capsys, algo,
                                                flags):
    report = train_main(["--algo", algo, *CLI, "--ckpt-dir",
                         str(tmp_path), *flags])
    out = capsys.readouterr().out
    assert f"algo={algo} env=hopper2d" in out
    assert [it for it, _ in report.evolutions] == [2, 4]
    assert torch.isfinite(torch.tensor(report.best_fitness))
    assert report.trainer.step_count == 4


def test_train_cli_refuses_the_engine_flags_beside_arch_or_lag1(tmp_path):
    with pytest.raises(ValueError, match="--algo only"):
        train_main(["--arch", "rwkv6-test", "--smoke", "--fused-epoch",
                    "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="nothing to overlap"):
        train_main(["--algo", "td3", *CLI, "--ckpt-dir", str(tmp_path),
                    "--fused-epoch", "--policy-lag", "1"])
