"""Serving engine and CLI of the port."""
