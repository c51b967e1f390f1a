"""Drivers of the port, one a configuration family."""
