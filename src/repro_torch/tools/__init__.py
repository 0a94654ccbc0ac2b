"""Diagnostic tools of the port."""
