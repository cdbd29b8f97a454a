"""The port's data prefetch and model accounting, held on the CPU against
the JAX package.

``Prefetcher`` and ``DoubleBuffer`` on the contract of
``tests/test_rl_envs_data.py`` (a bounded queue in order; a batch ahead),
the producer's exception raised by ``__next__``, every batch yielded and
copied; ``param_count``, ``active_param_count`` and ``model_flops``
(``repro_torch.models.accounting``) equal to JAX's exactly for every
config of the registry and every applicable shape, counted from shapes
on the ``meta`` device. (Under 11 tests: ROADMAP §3 on xdist's file
queue.)
"""
import time

import numpy as np
import pytest
import torch

from repro.configs.base import LM_SHAPES as JAX_SHAPES
from repro.configs.base import applicable_shapes as jax_applicable
from repro.configs.registry import get_config as jax_get_config
from repro.models import accounting as jax_accounting
from repro_torch.configs import (LM_SHAPES, ShapeSpec, applicable_shapes,
                                 get_config, list_configs)
from repro_torch.data import DoubleBuffer, Prefetcher
from repro_torch.models import accounting
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)


def test_prefetcher_and_double_buffer():
    it = iter(range(100))
    pf = Prefetcher(lambda: np.asarray([next(it)]), depth=2)
    vals = [int(next(pf)[0]) for _ in range(5)]
    assert vals == [0, 1, 2, 3, 4]
    pf.close()
    db = DoubleBuffer(iter([np.ones(2), np.zeros(2), np.ones(2)]),
                      device="cpu")
    out = next(db)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), np.ones(2))


def test_prefetcher_raises_the_producers_exception():
    calls = []

    def producer():
        calls.append(1)
        if len(calls) > 2:
            raise KeyError("the producer failed")
        return len(calls)

    pf = Prefetcher(producer, depth=4)
    got = []
    with pytest.raises(KeyError, match="the producer failed"):
        for _ in range(10):      # queued items may come first, or not
            got.append(next(pf))
    assert got == [1, 2][:len(got)]
    pf.close()


def test_double_buffer_yields_every_batch_as_a_copy():
    """Trees of numpy arrays and tensors, each batch a copy the producer
    may overwrite, the last one included; the card is the default
    device, so without one the buffer raises."""
    host = [{"obs": np.full((2, 3), i, np.float32),
             "done": torch.full((2,), i % 2, dtype=torch.bool)}
            for i in range(4)]
    out = list(DoubleBuffer(iter(host), device="cpu"))
    assert len(out) == 4
    for i, batch in enumerate(out):
        np.testing.assert_array_equal(batch["obs"].numpy(), host[i]["obs"])
        assert torch.equal(batch["done"], host[i]["done"])
    host[0]["obs"][:] = -1
    host[0]["done"].fill_(True)
    assert (out[0]["obs"] == 0).all() and not out[0]["done"].any()
    assert list(DoubleBuffer(iter([]), device="cpu")) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DoubleBuffer(iter(host))


def test_shapes_match_jax():
    assert list(LM_SHAPES) == list(JAX_SHAPES)
    for name, shape in LM_SHAPES.items():
        assert isinstance(shape, ShapeSpec)
        j = JAX_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) \
            == (j.name, j.seq_len, j.global_batch, j.kind)
    for arch in list_configs():
        assert applicable_shapes(get_config(arch)) == jax_applicable(
            jax_get_config(arch))


def test_accounting_matches_jax_for_every_config_and_shape():
    for arch in list_configs():
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert accounting.param_count(cfg) == \
            jax_accounting.param_count(jcfg), arch
        assert accounting.active_param_count(cfg) == \
            jax_accounting.active_param_count(jcfg), arch
        for name in applicable_shapes(cfg):
            assert accounting.model_flops(cfg, LM_SHAPES[name]) == \
                jax_accounting.model_flops(jcfg, JAX_SHAPES[name]), \
                (arch, name)


def test_accounting_allocates_nothing_and_is_fast():
    """Every registry config counted from ``meta`` tensors (about 0.5 s
    for all eleven on one core, qwen3-moe-30b-a3b's 30.5 B parameters
    included; the bound leaves room for a loaded machine, and drawing
    them would take minutes and some 120 GB), and the paths JAX's rules
    read: experts, the shared block, the table."""
    accounting.param_count(get_config("rwkv6-test"))   # imports, warm-up
    t0 = time.perf_counter()
    for arch in list_configs():
        shapes = accounting.param_shapes(get_config(arch))
        assert shapes and all(isinstance(s, tuple) for _, s in shapes)
    assert time.perf_counter() - t0 < 10.0
    paths = [p for p, _ in accounting.param_shapes(
        get_config("qwen3-moe-30b-a3b"))]
    assert any("experts" in p for p in paths)
    assert any(p.startswith("embed") for p in paths)
    assert any(p.startswith("shared_attn") for p in
               (q for q, _ in accounting.param_shapes(
                   get_config("zamba2-7b"))))
    assert accounting.param_count(get_config("qwen3-moe-30b-a3b")) == \
        30_532_122_624
