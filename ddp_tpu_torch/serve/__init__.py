"""Continuous-batching serving: scheduler, engine, HTTP server, CLI."""
