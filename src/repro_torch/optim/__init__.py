"""The optimizer of the training path: AdamW."""
