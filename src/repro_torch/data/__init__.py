"""repro_torch.data — the token pipeline (numpy; batches are a pure
function of (seed, step))."""
