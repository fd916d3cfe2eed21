"""Command-line tools that drive the port on the card (run with `python -m`)."""
