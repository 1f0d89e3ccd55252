"""Parallel strategies of the port (the one-rank subset so far)."""
