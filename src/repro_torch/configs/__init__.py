"""Per-architecture configs — one module per architecture the port runs."""
