"""Operators of the ported slice: keys, scans, the view sort, movement."""
