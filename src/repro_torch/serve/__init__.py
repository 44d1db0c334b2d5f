"""Serving entry point: the planner-routed ``SpGEMMServer``."""
