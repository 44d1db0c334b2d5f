"""The LM zoo (every family of the configs) and the sparse linear layer."""
