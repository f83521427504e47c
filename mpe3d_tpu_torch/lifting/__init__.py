"""Lifter input packing."""
