"""Dataset loaders (Blender)."""
