"""Observability of the port's serving stack (`metrics`)."""
