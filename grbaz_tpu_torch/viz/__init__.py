"""Host-side views of the port's outputs."""
