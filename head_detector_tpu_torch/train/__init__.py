"""Training runtime of the port: assigner, losses, AdamW + EMA train step,
synthetic rendered data, checkpoints and the epoch loop (``runner``)."""
