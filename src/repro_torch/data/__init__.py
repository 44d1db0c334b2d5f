"""The deterministic synthetic data pipeline of the training path."""
