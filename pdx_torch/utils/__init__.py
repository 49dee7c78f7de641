"""Host-memory helpers."""
