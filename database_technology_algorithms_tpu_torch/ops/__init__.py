"""Operators of the ported slice: keys, scans, the view sort, movement,
filter and aggregate."""

from .aggregate import group_aggregate
from .filter import compact, filter_batch, truncate

__all__ = ["compact", "filter_batch", "group_aggregate", "truncate"]
