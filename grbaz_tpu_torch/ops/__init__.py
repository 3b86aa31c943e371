"""Signal-processing blocks and ops of the port."""
