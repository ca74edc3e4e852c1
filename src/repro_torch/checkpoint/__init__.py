"""Read side of the per-expert npz checkpoints."""
