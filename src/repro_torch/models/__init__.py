"""The LM zoo (ssm and hybrid families) and the sparse linear layer."""
