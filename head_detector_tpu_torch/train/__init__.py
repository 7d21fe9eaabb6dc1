"""Training-side helpers of the port (this slice: synthetic scene rendering)."""
