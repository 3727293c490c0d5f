"""Observability layer of the port: only the spec types so far."""
