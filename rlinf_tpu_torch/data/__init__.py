"""Host-side data structures."""
