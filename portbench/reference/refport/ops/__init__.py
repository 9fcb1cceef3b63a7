"""Small rigid-body math on torch tensors."""
