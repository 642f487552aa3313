"""Shared utilities: the model summary."""

from .summary import count_parameters, summarize  # noqa: F401
