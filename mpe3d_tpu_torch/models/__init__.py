"""The matcher and lifter modules."""
