"""Model zoo of the port (dense decoder-only family so far)."""
