"""repro_torch.configs — copies of ``src/repro/configs/base.py``,
``registry.py`` and the ten one-line ``<arch>.py`` modules (each
``CONFIG``, the registry's entry; pure dataclasses and data).  The JAX
package's ``configs/shapes.py`` is not ported yet."""
