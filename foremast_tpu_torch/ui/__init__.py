"""Dashboard plane (the foremast-browser equivalent): the port's copy of
the JAX package's `foremast_tpu/ui/`, served on the standard library's
HTTP server."""

from foremast_tpu_torch.ui.metrics import DEFAULT_PANELS, Panel, dashboard_config

__all__ = ["DEFAULT_PANELS", "Panel", "dashboard_config"]
