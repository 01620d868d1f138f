"""Host setup utilities, linear algebra and hierarchy conversion."""
