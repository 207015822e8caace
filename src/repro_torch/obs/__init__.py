"""Host-side metrics registry."""
