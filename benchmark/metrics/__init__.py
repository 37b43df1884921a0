"""Per-layer metrics (``<name>.json``) and their readers."""
