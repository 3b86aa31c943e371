"""Spine of the port: streams, blocks, the flowgraph and the host executor."""
