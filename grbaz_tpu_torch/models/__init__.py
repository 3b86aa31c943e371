"""Composed chains of the port."""
