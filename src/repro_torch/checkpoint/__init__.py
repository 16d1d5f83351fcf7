"""repro_torch.checkpoint — atomic, asynchronous checkpoints in the JAX
package's on-disk layout."""
