"""Training: optimizers, the compiled-epoch runner, the trainer and CLI."""
