"""Trace arithmetic, peaks and kernel work counts: the yardstick."""
