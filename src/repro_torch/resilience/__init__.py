"""Numerical guardrails of the port (``repro_torch.resilience``)."""
