"""Observability of the port: the drain-stage scopes (``trace.py``) and
the telemetry plane's host side (``telemetry.py``)."""
