"""REST job gateway (foremast-service equivalent) on the standard
library's HTTP server."""

from foremast_tpu_torch.service.app import Gateway, make_app, make_server, serve

__all__ = ["Gateway", "make_app", "make_server", "serve"]
