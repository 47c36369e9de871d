"""Workflows built on the port: the linear inversion of :mod:`.inversion`."""
