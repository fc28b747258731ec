"""Executor, initializers and parameter carrying."""
