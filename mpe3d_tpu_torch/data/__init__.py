"""Wire-format parsing and synthetic scenes (numpy)."""
