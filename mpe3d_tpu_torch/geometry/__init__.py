"""Camera geometry and triangulation on torch tensors."""
