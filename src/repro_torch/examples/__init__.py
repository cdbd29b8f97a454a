"""The paper's case studies on the port: ``cemrl`` (§5.2), ``dvd``
(§5.3), ``pbt_ppo`` and ``population_lm`` (PBT over a language model),
each a ``run(...)`` and a ``python -m`` entry point."""
