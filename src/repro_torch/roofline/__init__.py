"""Roofline constants (the port's copy of ``roofline/hw``)."""
