"""Host-side image ingestion and result artifacts."""
