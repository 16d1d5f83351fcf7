"""repro_torch.launch — command-line entry points (``serve``: the async
solver server driven by a fault-laced load generator)."""
