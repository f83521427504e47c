"""Utilities of the command line: the profiler trace."""
