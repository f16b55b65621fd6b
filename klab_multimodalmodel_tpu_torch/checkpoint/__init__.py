"""Weight conversion into the port's state dicts, and checkpoints."""
