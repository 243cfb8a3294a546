"""Composed query pipelines."""
