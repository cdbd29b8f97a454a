"""The agent adapters of ``repro.pop`` (``ModuleAgent`` so far)."""
from repro_torch.pop.agent import ModuleAgent  # noqa: F401
