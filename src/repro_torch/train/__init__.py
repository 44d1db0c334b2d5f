"""The training step: microbatching, remat, compression, AdamW."""
