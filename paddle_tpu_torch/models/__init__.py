"""Model zoo of the port (GPT decode in the serving slice)."""
