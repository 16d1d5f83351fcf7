"""repro_torch.train — the training loop.

    train_step    loss_fn (next-token CE + MoE aux terms) and the step:
                  gradients, microbatch accumulation, compression, AdamW
    trainer       Trainer: checkpoint / resume, NaN rollback, straggler
                  EWMA, the final checkpoint on SIGTERM
"""
