"""The paper's case studies on the port: ``cemrl`` (§5.2) and ``dvd``
(§5.3), each a ``run(...)`` and a ``python -m`` entry point."""
