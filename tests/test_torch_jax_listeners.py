"""A guard the port's JAX parity test files share.

``repro.compat.register_compile_listener`` hands back an unregister
callable that fails silently on jax 0.9.0, so a JAX test of this repo
that registers a compile listener leaves it behind
(``tests/test_fused_epoch.py``'s, whose callback takes one argument where
the listener passes two). Every later JAX compile in the same pytest
worker then raises ``TypeError`` in that callback. Under ``--dist
loadfile`` which files share a worker changes with the suite, so a port
test file that compares against JAX can land behind it.

Each port test file that calls JAX imports :func:`drop_leaked_jax_listeners`
(an autouse fixture): before each of its tests it unregisters every event
duration listener that was not registered when this module was imported.
"""
import jax
import jax.numpy as jnp
import pytest
from jax._src import monitoring

_AT_IMPORT = tuple(monitoring.get_event_duration_listeners())


def _drop_leaked():
    for callback in list(monitoring.get_event_duration_listeners()):
        if callback not in _AT_IMPORT:
            monitoring.unregister_event_duration_listener(callback)


@pytest.fixture(autouse=True)
def drop_leaked_jax_listeners():
    _drop_leaked()
    yield


def test_a_leaked_compile_listener_is_dropped():
    """A listener of the leaked kind breaks the next compile; once dropped,
    compiles run again."""
    monitoring.register_event_duration_secs_listener(lambda info: None)
    fn = jax.jit(lambda x: x * 3 + 1)
    with pytest.raises(TypeError):
        fn(jnp.ones(5))
    _drop_leaked()
    assert list(monitoring.get_event_duration_listeners()) == \
        list(_AT_IMPORT)
    assert float(jax.jit(lambda x: x * 5 - 2)(jnp.ones(4)).sum()) == 12.0
