"""Telemetry of the port (counterpart of ``bigdl_tpu.obs``): the
process-wide metrics registry the serving tier stamps, the family
names, and the request-trace header."""

from bigdl_tpu_torch.obs.metrics import MetricsRegistry

_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide metrics registry."""
    return _registry


__all__ = ["MetricsRegistry", "get_registry"]
