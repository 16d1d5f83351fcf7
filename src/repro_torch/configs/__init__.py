"""repro_torch.configs — copies of ``src/repro/configs/base.py`` and
``registry.py`` (pure dataclasses and data; the JAX package's
``configs/shapes.py`` is not ported yet)."""
