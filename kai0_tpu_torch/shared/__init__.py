"""Host helpers without JAX: norm stats and image resizing."""
