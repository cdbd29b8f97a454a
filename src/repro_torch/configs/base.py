"""``HyperSpace`` and ``PopulationConfig``, copied from the JAX package's
``repro.configs.base`` (the port imports nothing of it). The fields of
the strategies not ported yet (CEM's, DvD's) come with them; ``donate``
has no counterpart in the eager port, nor have ``fused_adam`` and
``fused_linear``: the port's update always runs the kernels on the card.
The LM configs come with the LM slice."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class HyperSpace:
    """Per-hyperparameter prior: log-uniform or uniform ranges (paper §B.1)."""
    log_uniform: tuple = ()   # ((name, lo, hi), ...)
    uniform: tuple = ()       # ((name, lo, hi), ...)

    @property
    def names(self):
        return tuple(n for n, _, _ in self.log_uniform) + \
               tuple(n for n, _, _ in self.uniform)


@dataclass(frozen=True)
class PopulationConfig:
    """The paper's technique as a config value.

    ``strategy`` picks the outer evolution loop (size 1 always degrades to
    none); ``backend`` picks how the update executes. Of these the port
    has ``pbt``/``none`` and ``vectorized``; the others raise "not ported
    yet" where they are resolved.
    """
    size: int = 1
    strategy: str = "pbt"
    backend: str = "vectorized"
    num_steps: int = 1                   # chained update steps per call (§4.1)
    pbt_interval: int = 100_000          # trainer steps between evolve calls
    exploit_frac: float = 0.3            # paper §B.1: bottom/top 30%
    perturb_prob: float = 0.5            # resample vs perturb
    perturb_scale: float = 1.2
    hyper_space: HyperSpace = field(default_factory=HyperSpace)
    fitness_window: int = 10             # last-k fitness rows
