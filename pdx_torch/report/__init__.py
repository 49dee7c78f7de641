"""Host-side figures (matplotlib)."""
