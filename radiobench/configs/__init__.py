"""Deployments: sizes (``<name>.json``) and how the port is built for them."""
