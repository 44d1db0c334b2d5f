"""Observability for the SpGEMM serving stack: tracing spans
(:mod:`repro_torch.obs.trace`), the metrics registry
(:mod:`repro_torch.obs.metrics`) and the cost-model drift auditor
(:mod:`repro_torch.obs.audit`)."""
