"""Command-line entry points; modules mirror scripts/."""
