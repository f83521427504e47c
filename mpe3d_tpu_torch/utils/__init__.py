"""Utilities: the JSONL event log, the numerics guard, the profiler
trace, the spans and counters of the port's host work."""
