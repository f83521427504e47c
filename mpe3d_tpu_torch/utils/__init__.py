"""Utilities: the JSONL event log, the numerics guard, the profiler
trace."""
