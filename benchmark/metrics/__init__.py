"""Per-layer metric readers: `<metric>.py`, each with `read(ctx)`."""
