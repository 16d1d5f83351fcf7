"""repro_torch.optim — the optimizer of the training step.

    adamw         AdamW with global-norm clipping and the warmup + cosine
                  schedule, float32 moments, one rounding to the param dtype
    compression   gradient compression (bf16 / int8) with error feedback
"""
