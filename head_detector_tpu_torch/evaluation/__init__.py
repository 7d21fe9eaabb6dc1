"""Evaluation helpers of the port (so far the batched aligned crops)."""
