"""Offline rendering of the port's results."""
