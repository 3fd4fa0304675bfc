"""Command-line options of the port's entry points."""
