"""Distribution: the planner-driven sparse pipeline, GPipe over
torch.distributed (pipeline_apply), int8 error-feedback gradient
compression and the elastic control plane."""
