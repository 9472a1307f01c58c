"""Framework core of the port (errors only in the serving slice)."""
