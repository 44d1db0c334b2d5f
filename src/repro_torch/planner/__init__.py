"""Amortization-aware SpGEMM planner: features, cost model, plan cache
and the planning/execution service."""
