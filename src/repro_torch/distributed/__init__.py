"""Distribution: the planner-driven sparse pipeline (one card)."""
