"""repro_torch.launch — command-line entry points (``serve``: the async
solver server driven by a fault-laced load generator; ``train``: the
training launcher) and the devices of the batched solver's split of K
(``mesh``)."""
