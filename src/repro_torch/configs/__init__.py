"""repro_torch.configs — copies of ``src/repro/configs/base.py``,
``registry.py`` and the ten one-line ``<arch>.py`` modules (each
``CONFIG``, the registry's entry; pure dataclasses and data), and
``shapes.py``: the input-shape suites and each cell's input specs as
``(shape, dtype)`` pairs."""
