"""The LLM that answers cache misses: the dense decoder stack (the port of
the reference's ``models`` package)."""
