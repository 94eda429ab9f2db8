"""Observability hooks of the port: only the drain-stage scope so far."""
