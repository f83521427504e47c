"""Matcher graph features and the person-proposal decode."""
