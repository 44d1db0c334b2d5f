"""Atomic, CRC-checked checkpoints of the training state."""
