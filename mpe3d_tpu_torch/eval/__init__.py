"""Evaluation: pose and matching metrics, the reference's test scripts."""
