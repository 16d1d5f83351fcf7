"""repro_torch.serve — the transformer substrate's serving steps
(``serve_step``: prefill, decode, the greedy loop).  The solver service of
the JAX package's ``serve/`` is not ported yet (ROADMAP.md)."""
