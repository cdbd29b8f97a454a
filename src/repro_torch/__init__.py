"""``repro_torch`` — the PyTorch and CUDA port of ``repro``.

Module names follow the JAX package, so each module's counterpart is found
under the same path (``repro.serve.server`` -> ``repro_torch.serve.server``).
The port imports ``torch`` and numpy, never ``jax`` or ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` on the command line); without CUDA and
without that, they raise (:func:`repro_torch.device.resolve_device`).
Parameters are plain nested dicts of tensors with the JAX package's names
and layouts, and randomness comes from explicit ``torch.Generator``s.
"""
