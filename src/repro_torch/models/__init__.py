"""repro_torch.models — the transformer substrate's serving slice.

    layers        attention (K7 in prefill), MLP, RWKV6 (K8 in prefill)
    transformer   init_params, forward, lm_logits, init_cache, decode_step
    convert       the JAX package's weights carried across
"""
