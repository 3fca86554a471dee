"""Deploy manifests of the port as code (see manifests.py)."""

from foremast_tpu_torch.deploy.manifests import render, render_file, tree

__all__ = ["render", "render_file", "tree"]
