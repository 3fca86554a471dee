"""`python -m foremast_tpu_torch.deploy [root]`: render the port's tree
(default `deploy_torch`)."""

import sys

from foremast_tpu_torch.deploy.manifests import render

if __name__ == "__main__":
    root = sys.argv[1] if len(sys.argv) > 1 else "deploy_torch"
    for path in render(root):
        print(path)
