"""repro_torch.obs — span tracing (:mod:`repro_torch.obs.trace`), the
counterpart of ``repro.obs.trace``.  Off by default; ``REPRO_TRACE=1``
in the environment or ``TRACER.enable()`` turns it on."""
from .trace import TRACER, Tracer, enabled, span

__all__ = ["TRACER", "Tracer", "enabled", "span"]
